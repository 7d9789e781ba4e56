"""Optical-flow estimators of the port: Farneback and LiteFlowNet so far."""

_NOT_PORTED = {
    "horn-schunck": "ROADMAP Queue 1, item 10 (secondary estimators)",
    "lukas-kanade": "ROADMAP Queue 1, item 10 (secondary estimators)",
}


def get_estimator(method: str):
    if method == "farneback":
        from .farneback import farneback
        return farneback
    if method == "liteflownet":
        from .liteflownet import liteflownet
        return liteflownet
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"flow method {method!r} is not ported yet: {_NOT_PORTED[method]}")
    raise ValueError(f"Unknown flow method {method!r}")
