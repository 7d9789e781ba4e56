"""The system under test: the port's ``Engine``, built from a
configuration file the way ``pipeline.py::Pipeline`` builds it for the
configuration's command line.

The command line (``argv``) goes through the port's own parser
(``cli.build_parser``, ``cli.config_from_args``), the estimator's settings
(``cv_config``) through its flow source, and the layers through
``make_layer_params``, each pixmap bound to its layers with a full
introduction mask. Only the decoders are left out: the harness hands the
Engine frames and a pixmap that it made itself. What the file states for
the reference (``direction``, ``layers``, ``background``) is checked
against what the port parsed, so the two cannot drift apart.
"""
import os

import numpy as np
import torch


def _port():
    """The port's modules (imported here, not when this module is)."""
    from transflow_tpu_torch import cli, engine
    from transflow_tpu_torch.compositor.core import make_layer_params
    from transflow_tpu_torch.flow.sources.base import FlowSource
    return cli, engine, make_layer_params, FlowSource


def program_config(config: dict, seed: int):
    """The port's ``Config`` of the configuration's command line, with
    ``seed`` as ``--seed`` and the file's ``cv_config``."""
    cli, *_ = _port()
    args = cli.build_parser().parse_args(
        list(config["argv"]) + ["--seed", str(int(seed))])
    cfg = cli.config_from_args(args)
    cfg.cv_config = dict(config["cv_config"])
    _agree(config, cfg)
    return cfg


def _agree(config: dict, cfg) -> None:
    """Raise where the port parsed the command line otherwise than the
    configuration file states it for the reference."""
    stated = {"direction": config["direction"],
              "background": config["background"],
              "layers": config["layers"]}
    parsed = {"direction": cfg.direction.name.lower(),
              "background": cfg.compositor_background,
              "layers": [{key: layer.todict()[key] for key in stated_layer}
                         for layer, stated_layer in zip(cfg.layers,
                                                        config["layers"])]}
    if parsed != stated or len(cfg.layers) != len(config["layers"]):
        raise ValueError(f"the configuration states {stated}, the port "
                         f"parsed {parsed}")


def build_engine(config: dict, seed: int, height: int, width: int,
                 framerate: float, device, weights: dict | None = None):
    """The Engine of ``config`` over frames of ``height`` x ``width``, on
    ``device``; ``weights`` (a LiteFlowNet state dict) are loaded into the
    estimator's network through its state dict."""
    cli, engine_mod, make_layer_params, FlowSource = _port()
    cfg = program_config(config, seed)
    if cfg.cv_config.get("method") == "liteflownet":
        # the Engine builds its network with the random weights of seed 0
        # (no checkpoint here); the seed's weights replace them below
        os.environ.setdefault("TRANSFLOW_LITEFLOWNET_RANDOM", "1")
    source = FlowSource.from_args(
        cfg.flow_path, use_mvs=cfg.use_mvs, mask_path=cfg.mask_path,
        kernel_path=cfg.kernel_path, cv_config=cfg.cv_config,
        flow_filters=cfg.flow_filters, direction=cfg.direction,
        repeat=cfg.repeat, lock_expr=cfg.lock_expr, lock_mode=cfg.lock_mode)
    source.width, source.height = width, height
    source.framerate = framerate
    sources_by_layer: dict = {}
    for pix_cfg in cfg.pixmap_sources:
        for layer_index in pix_cfg.layers:
            sources_by_layer.setdefault(layer_index, []).append(
                (3, np.ones((height, width), dtype=bool)))
    layer_params = make_layer_params(cfg.layers, height, width,
                                     sources_by_layer, device=device)
    eng = engine_mod.Engine(cfg, [source], layer_params, height, width,
                            device=device)
    eng._framerate = framerate
    if weights is not None:
        eng.runtimes[0].estimator_step.params.load_state_dict(weights)
    return eng


def frame_channels(config: dict) -> int:
    """Channels of the frames the estimator reads: gray (1) except for
    LiteFlowNet (RGB), as the port's frame source decodes them."""
    return 3 if config["cv_config"].get("method") == "liteflownet" else 1


def state_arrays(engine, comp_state) -> dict:
    """``Engine.state_arrays`` of ``comp_state`` (a snapshot of the
    Engine's compositor state), the checkpoint's names and dtypes."""
    live = engine.comp_state
    engine.comp_state = comp_state
    try:
        return engine.state_arrays()
    finally:
        engine.comp_state = live
