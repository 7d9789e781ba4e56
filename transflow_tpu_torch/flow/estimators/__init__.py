"""Optical-flow estimators of the port: Farneback, Horn-Schunck,
Lucas-Kanade and LiteFlowNet, by the JAX package's method names."""


def get_estimator(method: str):
    if method == "farneback":
        from .farneback import farneback
        return farneback
    if method == "horn-schunck":
        from .horn_schunck import horn_schunck
        return horn_schunck
    if method == "lukas-kanade":
        from .lucas_kanade import lucas_kanade
        return lucas_kanade
    if method == "liteflownet":
        from .liteflownet import liteflownet
        return liteflownet
    raise ValueError(f"Unknown flow method {method!r}")
