"""Optical-flow estimators of the port. Only LiteFlowNet is ported so far."""

_NOT_PORTED = {
    "farneback": "ROADMAP Queue 1, item 3 (Farneback)",
    "horn-schunck": "ROADMAP Queue 1, item 10 (secondary estimators)",
    "lukas-kanade": "ROADMAP Queue 1, item 10 (secondary estimators)",
}


def get_estimator(method: str):
    if method == "liteflownet":
        from .liteflownet import liteflownet
        return liteflownet
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"flow method {method!r} is not ported yet: {_NOT_PORTED[method]}")
    raise ValueError(f"Unknown flow method {method!r}")
