"""Command-line interface of the port: the transflow flag mini-language.

Counterpart of transflow_tpu/cli.py, with the same flags, defaults, errors
and positional mini-language (tests/test_torch_cli.py holds both parsers
to the same option strings and configs): ``-p SRC [LAYER...]`` appends a
pixmap and binds it to layers, and the pixmap flags that follow
(--introduction, --alteration, --pixmap-seek, --pixmap-repeat) attach to
the last pixmap; ``-l INDEX [CLASS]`` appends a layer and the layer flags
that follow attach to the last layer; ``-r MODE [FACTOR]`` and ``--lock
MODE EXPR`` follow the same convention. The action routes as there:
'*.json' -> config file, '*.ckpt.zip' -> resume, 'gui' -> the web GUI
(``gui/server.py``), else flow source (a video file, a camera index, an
image sequence or a .flow.zip), 'bench' -> the port's bench
(``bench.py``).
"""
import argparse
import json
import pathlib

from . import __version__

class _AppendPixmap(argparse.Action):

    def __call__(self, parser, namespace, values, option_string=None):
        pixmaps = getattr(namespace, "pixmap_sources", None)
        if pixmaps is None:
            pixmaps = []
            namespace.pixmap_sources = pixmaps
        if not values:
            parser.error("too few arguments for -p, --pixmap")
        layers = []
        for value in values[1:]:
            try:
                layers.append(int(value))
            except ValueError:
                parser.error(f"pixmap layer: invalid int value: '{value}'")
        pixmaps.append({"path": values[0], "layers": layers or [0]})


class _SetPixmap(argparse.Action):

    def __call__(self, parser, namespace, values, option_string=None):
        pixmaps = getattr(namespace, "pixmap_sources", None)
        if not pixmaps:
            parser.error(f"{option_string} must follow a -p/--pixmap")
        pixmaps[-1][self.dest] = values


def _last_layer(namespace):
    layers = getattr(namespace, "layers", None)
    if layers is None:
        layers = []
        namespace.layers = layers
    if not layers:
        layers.append({"index": 0})
    return layers[-1]


class _AppendLayer(argparse.Action):

    CLASSNAMES = sorted(["moveref", "introduction", "static", "sum"])

    def __call__(self, parser, namespace, values, option_string=None):
        layers = getattr(namespace, "layers", None)
        if layers is None:
            layers = []
            namespace.layers = layers
        if len(values) == 1:
            index, classname = values[0], "moveref"
        elif len(values) == 2:
            index, classname = values
        else:
            parser.error("too many arguments for -l, --layer")
        try:
            index = int(index)
        except ValueError:
            parser.error(f"layer index: invalid int value: '{index}'")
        if classname not in self.CLASSNAMES:
            parser.error(f"layer class: invalid choice: '{classname}' "
                         f"(choose from {', '.join(self.CLASSNAMES)})")
        layers.append({"index": index, "classname": classname})


class _SetLayer(argparse.Action):

    def __call__(self, parser, namespace, values, option_string=None):
        _last_layer(namespace)[self.dest] = values


class _ConstLayer(argparse.Action):

    def __call__(self, parser, namespace, values, option_string=None):
        _last_layer(namespace)[self.dest] = self.const


class _ResetAction(argparse.Action):

    MODES = sorted(["off", "random", "constant", "linear"])

    def __call__(self, parser, namespace, values, option_string=None):
        if len(values) == 1:
            mode = values[0]
            factor = 1.0 if mode == "constant" else 0.1
        elif len(values) == 2:
            mode, factor = values
        else:
            parser.error("reset: expected 1 or 2 arguments")
        if mode not in self.MODES:
            parser.error(f"reset mode: invalid choice: '{mode}' "
                         f"(choose from {', '.join(self.MODES)})")
        try:
            factor = float(factor)
        except ValueError:
            parser.error(f"reset factor: invalid float value: '{factor}'")
        layer = _last_layer(namespace)
        layer["reset_mode"] = mode
        layer["reset_factor"] = factor


class _LockAction(argparse.Action):

    MODES = sorted(["stay", "skip"])

    def __call__(self, parser, namespace, values, option_string=None):
        if len(values) != 2:
            parser.error("lock: expected 2 arguments")
        mode, expr = values
        if mode not in self.MODES:
            parser.error(f"lock mode: invalid choice: '{mode}' "
                         f"(choose from {', '.join(self.MODES)})")
        namespace.lock_mode = mode
        namespace.lock_expr = expr


MASK_HELP = (", either a path to an image file (luminance maps to [0, 1]) or "
             "one of 'zeros', 'ones', 'random', 'border:t:r:b:l', "
             "'border-top:h', 'border-right:w', 'border-bottom:h', "
             "'border-left:w', 'hline:h', 'vline:w', 'circle:r', "
             "'rect:w:h', 'grid:rows:cols:r'; dimensions are pixels or "
             "'%%'-relative; append ':inv' to invert")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="transflow-tpu-torch",
        description="optical flow transfer on PyTorch and CUDA",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument("-v", "--version", action="version",
                        version=f"transflow-tpu-torch v{__version__}")
    parser.add_argument(
        "action", type=str,
        help="a flow source (video path, webcam index or .flow.zip), a "
        "checkpoint (.ckpt.zip), a JSON config file, 'gui', or 'bench'")

    group = parser.add_argument_group("flow options")
    group.add_argument("--flow", dest="extra_flow_paths", type=str, nargs="*",
                       help="additional flow sources")
    group.add_argument("--merge", dest="flows_merging_function", type=str,
                       default="sum",
                       choices=["first", "sum", "average", "difference",
                                "product", "maskbin", "masklin", "absmax"],
                       help="function to merge all flow sources")
    group.add_argument("--mv", dest="use_mvs", action="store_true",
                       help="extract flow from encoded motion vectors")
    group.add_argument("--mask", dest="mask_path", type=str, default=None,
                       help="pixel-wise flow scaling float mask" + MASK_HELP)
    group.add_argument("--kernel", dest="kernel_path", type=str, default=None,
                       help="path to an NPY convolution kernel applied to "
                       "the flow")
    group.add_argument("-c", "--cv-config", dest="cv_config", type=str,
                       default=None,
                       help="JSON file of estimator settings, or 'window'")
    group.add_argument("-f", "--filters", dest="flow_filters", type=str,
                       default=None,
                       help="semicolon-separated flow filters "
                       "(scale/threshold/clip/polar), expressions of t")
    group.add_argument("-d", "--direction", type=str,
                       choices=["forward", "backward"], default="backward",
                       help="flow direction; 'backward' is smoother, "
                       "'forward' grainier")
    group.add_argument("-s", "--seek", dest="seek_time", type=str,
                       default=None, help="flow start timestamp HH:MM:SS.FFF")
    group.add_argument("-t", "--duration", dest="duration_time", type=str,
                       default=None, help="max output duration")
    group.add_argument("--to", dest="to_time", type=str, default=None,
                       help="flow end timestamp")
    group.add_argument("--repeat", type=int, default=1,
                       help="repeat flow inputs (0 = loop forever)")
    group.add_argument("--lock", action=_LockAction, nargs=2, type=str,
                       metavar=("MODE", "EXPR"),
                       help="lock the flow: mode 'stay' pauses the source "
                       "('EXPR' = list of (start, duration) couples), "
                       "'skip' keeps reading (EXPR = boolean expression "
                       "of t)")

    group = parser.add_argument_group("pixmap options")
    group.add_argument("-p", "--pixmap", action=_AppendPixmap, nargs="+",
                       metavar=("source", "layer"), type=str,
                       help="pixmap source: video/image path or "
                       "color[:css]/noise/bwnoise/cnoise/gradient/first, "
                       "followed by target layer indices")
    group.add_argument("--alteration", dest="pixmap_alteration",
                       action=_SetPixmap, type=str, default=None,
                       help="PNG overlay applied to the last pixmap")
    group.add_argument("-i", "--introduction", dest="introduction_path",
                       action=_SetPixmap, type=str, default=None,
                       help="boolean introduction mask for the last pixmap"
                       + MASK_HELP)
    group.add_argument("--pixmap-seek", action=_SetPixmap, type=str,
                       default=None,
                       help="start timestamp for the last pixmap")
    group.add_argument("--pixmap-repeat", action=_SetPixmap, type=int,
                       default=1,
                       help="repeat the last pixmap (0 = loop forever)")

    group = parser.add_argument_group("compositor options")
    group.add_argument("--background", dest="compositor_background",
                       type=str, default="#ffffff",
                       help="background color, CSS format")

    group = parser.add_argument_group("layer options")
    group.add_argument("-l", "--layer", action=_AppendLayer, nargs="+",
                       metavar=("index", "class"), type=str,
                       help="declare a layer: index + class "
                       "(moveref/introduction/static/sum)")
    group.add_argument("--mask-alpha", dest="mask_alpha", action=_SetLayer,
                       type=str, default=None,
                       help="layer opacity mask" + MASK_HELP)
    group.add_argument("--move-mask-source", dest="mask_src",
                       action=_SetLayer, type=str, default=None,
                       help="mask of allowed movement sources" + MASK_HELP)
    group.add_argument("--move-mask-destination", dest="mask_dst",
                       action=_SetLayer, type=str, default=None,
                       help="mask of allowed movement destinations"
                       + MASK_HELP)
    group.add_argument("--move-from-empty",
                       dest="transparent_pixels_can_move",
                       action=_ConstLayer, const=True, nargs=0,
                       help="allow transparent pixels to move")
    group.add_argument("--no-move-to-empty",
                       dest="pixels_can_move_to_empty_spot",
                       action=_ConstLayer, const=False, nargs=0,
                       help="prevent moves onto empty spots")
    group.add_argument("--no-move-to-filled",
                       dest="pixels_can_move_to_filled_spot",
                       action=_ConstLayer, const=False, nargs=0,
                       help="prevent moves onto filled spots")
    group.add_argument("-e", "--leave-empty-spot",
                       dest="moving_pixels_leave_empty_spot",
                       action=_ConstLayer, const=True, nargs=0,
                       help="moving pixels leave an empty spot behind")
    group.add_argument("-r", "--reset", action=_ResetAction, nargs="+",
                       metavar=("mode", "factor"), type=str,
                       help="reset mode (off/random/constant/linear) and "
                       "factor")
    group.add_argument("-m", "--reset-mask", dest="reset_mask",
                       action=_SetLayer, type=str,
                       help="mask selecting where resets apply" + MASK_HELP)
    group.add_argument("--reset-source", action=_ConstLayer, const=True,
                       nargs=0, dest="reset_source",
                       help="random reset also resets the source index")
    group.add_argument("--no-introduce-on-empty",
                       dest="introduce_pixels_on_empty_spots",
                       action=_ConstLayer, const=False, nargs=0,
                       help="no introduction on empty spots")
    group.add_argument("--no-introduce-on-filled",
                       dest="introduce_pixels_on_filled_spots",
                       action=_ConstLayer, const=False, nargs=0,
                       help="no introduction on filled spots")
    group.add_argument("--no-introduce-moving",
                       dest="introduce_moving_pixels",
                       action=_ConstLayer, const=False, nargs=0,
                       help="no introduction of moving pixels")
    group.add_argument("--no-introduce-unmoving",
                       dest="introduce_unmoving_pixels",
                       action=_ConstLayer, const=False, nargs=0,
                       help="no introduction of unmoving pixels")
    group.add_argument("-n", "--introduce-once", dest="introduce_once",
                       action=_ConstLayer, const=True, nargs=0,
                       help="introduce pixels only on the first frame")
    group.add_argument("-a", "--introduce-on-all-filled",
                       dest="introduce_on_all_filled_spots",
                       action=_ConstLayer, const=True, nargs=0,
                       help="force introduction on all filled spots")
    group.add_argument("--introduce-on-all-empty",
                       dest="introduce_on_all_empty_spots",
                       action=_ConstLayer, const=True, nargs=0,
                       help="force introduction on all empty spots")

    group = parser.add_argument_group("output options")
    group.add_argument("-o", "--output", dest="output", type=str,
                       action="append",
                       help="output: video path, image template "
                       "('foo-%%02d.png') or 'mjpeg[:port[:host]]'; default "
                       "opens a preview window")
    group.add_argument("--vcodec", type=str, default="h264",
                       help="output video codec")
    group.add_argument("--size", type=str, default=None,
                       help="input webcam size WIDTHxHEIGHT")
    group.add_argument("--view-flow", action="store_true",
                       help="render the flow itself")
    group.add_argument("--view-flow-magnitude", action="store_true",
                       help="render the flow magnitude")
    group.add_argument("--render-scale", type=float, default=0.1,
                       help="flow rendering scale")
    group.add_argument("--render-colors", type=str, default=None,
                       help="flow rendering colors (CSS, comma separated; "
                       "4 for flow, 2 for magnitude)")
    group.add_argument("--render-binary", action="store_true",
                       help="binary (two-color) magnitude rendering")

    group = parser.add_argument_group("general options")
    group.add_argument("--seed", type=int, default=None, help="random seed")
    group.add_argument("--batch-frames", type=int, default=None,
                       help="frames per Engine chunk (default: chunk "
                       "eligible renders, 1 disables)")
    group.add_argument("--mesh", type=str, default=None,
                       help="shard the render over N cards ('8' or '1x8'; "
                       "N views of the CPU on the CPU): LiteFlowNet's "
                       "correlation and the movement gather split along H")
    group.add_argument("--halo", type=int, default=None,
                       help="movement-gather row bound under --mesh "
                       "(neighbor-row exchange instead of full-state "
                       "all-gathers; auto-derived from a constant clip "
                       "filter)")

    group = parser.add_argument_group("processing options")
    group.add_argument("-S", "--safe", action="store_true",
                       help="checkpoint on interruption or error")
    group.add_argument("--checkpoint-every", type=int, default=None,
                       help="export a checkpoint every N frames")
    group.add_argument("-C", "--checkpoint-end", action="store_true",
                       help="export a checkpoint at the last frame")
    group.add_argument("--no-exec", dest="execute", action="store_false",
                       help="do not open the output file when done")
    group.add_argument("--overwrite", dest="replace", action="store_true",
                       help="overwrite existing outputs")
    group.add_argument("--no-config-export", dest="export_config",
                       action="store_false",
                       help="disable automatic config export")
    group.add_argument("-F", "--export-flow", action="store_true",
                       help="export the computed flow as a .flow.zip")
    group.add_argument("--export-rounded-flow", dest="round_flow",
                       action="store_true",
                       help="export the flow as integers (lighter)")
    group.add_argument("-O", "--preview-output", action="store_true",
                       help="preview the output while exporting")
    group.add_argument("--log-level", type=str, default="DEBUG",
                       choices=["DEBUG", "INFO", "WARNING", "ERROR",
                                "CRITICAL"])
    group.add_argument("--log-handler", type=str, default="null",
                       help="comma-separated: file, stream or null")
    group.add_argument("--log-path", type=pathlib.Path,
                       default=pathlib.Path("transflow.log"))
    group.add_argument("--profile", action="store_true",
                       help="print per-stage frame timing at the end and "
                       "write <output>.profile.json")
    group.add_argument("--trace-dir", type=str, default=None,
                       help="capture a torch.profiler trace (Chrome "
                       "trace format) into this directory")

    group = parser.add_argument_group("GUI options")
    group.add_argument("--gui-host", type=str, default="localhost")
    group.add_argument("--gui-port", type=int, default=8000)
    group.add_argument("--gui-mjpeg-port", type=int, default=8001)
    return parser


def config_from_args(args) -> "Config":
    from .config import Config, LayerConfig, PixmapSourceConfig
    if args.action.endswith(".json"):
        with open(args.action) as file:
            return Config.fromdict(json.load(file))
    return Config(
        args.action,
        extra_flow_paths=args.extra_flow_paths,
        flows_merging_function=args.flows_merging_function,
        use_mvs=args.use_mvs,
        mask_path=args.mask_path,
        kernel_path=args.kernel_path,
        cv_config=args.cv_config,
        flow_filters=args.flow_filters,
        direction=args.direction,
        seek_time=args.seek_time,
        duration_time=args.duration_time,
        to_time=args.to_time,
        repeat=args.repeat,
        lock_expr=getattr(args, "lock_expr", None),
        lock_mode=getattr(args, "lock_mode", None),
        pixmap_sources=[
            PixmapSourceConfig(
                d["path"],
                seek_time=d.get("pixmap_seek"),
                alteration_path=d.get("pixmap_alteration"),
                introduction_path=d.get("introduction_path"),
                repeat=d.get("pixmap_repeat"),
                layers=d["layers"],
            )
            for d in getattr(args, "pixmap_sources", None) or []
        ],
        layers=[
            LayerConfig(
                d["index"],
                classname=d.get("classname"),
                mask_alpha=d.get("mask_alpha"),
                mask_src=d.get("mask_src"),
                mask_dst=d.get("mask_dst"),
                transparent_pixels_can_move=d.get(
                    "transparent_pixels_can_move"),
                pixels_can_move_to_empty_spot=d.get(
                    "pixels_can_move_to_empty_spot"),
                pixels_can_move_to_filled_spot=d.get(
                    "pixels_can_move_to_filled_spot"),
                moving_pixels_leave_empty_spot=d.get(
                    "moving_pixels_leave_empty_spot"),
                reset_mode=d.get("reset_mode"),
                reset_mask=d.get("reset_mask"),
                reset_random_factor=d.get("reset_factor"),
                reset_constant_step=d.get("reset_factor"),
                reset_linear_factor=d.get("reset_factor"),
                reset_source=d.get("reset_source"),
                introduce_pixels_on_empty_spots=d.get(
                    "introduce_pixels_on_empty_spots"),
                introduce_pixels_on_filled_spots=d.get(
                    "introduce_pixels_on_filled_spots"),
                introduce_moving_pixels=d.get("introduce_moving_pixels"),
                introduce_unmoving_pixels=d.get("introduce_unmoving_pixels"),
                introduce_once=d.get("introduce_once"),
                introduce_on_all_filled_spots=d.get(
                    "introduce_on_all_filled_spots"),
                introduce_on_all_empty_spots=d.get(
                    "introduce_on_all_empty_spots"),
            )
            for d in getattr(args, "layers", None) or []
        ],
        compositor_background=args.compositor_background,
        output_path=args.output,
        vcodec=args.vcodec,
        size=args.size,
        view_flow=args.view_flow,
        view_flow_magnitude=args.view_flow_magnitude,
        render_scale=args.render_scale,
        render_colors=args.render_colors,
        render_binary=args.render_binary,
        seed=args.seed,
        batch_frames=args.batch_frames,
        mesh=args.mesh,
        halo=args.halo,
    )


def main(argv=None, device=None):
    """Run the command line ``argv`` (``sys.argv[1:]`` when None) and
    return its Pipeline (the ``GuiServer`` for ``gui``, once it stops; the
    bench's record for ``bench``). ``device``: where the render runs, the
    current CUDA device by default (no card raises); ``"cpu"`` runs it on
    the CPU."""
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.action == "gui":
        from .gui.server import start_gui
        return start_gui(args.gui_host, args.gui_port, args.gui_mjpeg_port,
                         device=device)
    if args.action == "bench":
        from . import bench
        return bench.main([], device=device)
    cfg = config_from_args(args)
    from .pipeline import Pipeline
    pipeline = Pipeline(
        cfg,
        safe=args.safe,
        checkpoint_every=args.checkpoint_every,
        checkpoint_end=args.checkpoint_end,
        execute=args.execute,
        replace=args.replace,
        export_config=args.export_config,
        export_flow=args.export_flow,
        round_flow=args.round_flow,
        preview_output=args.preview_output,
        log_level=args.log_level,
        log_handler=args.log_handler,
        log_path=args.log_path,
        profile=args.profile,
        trace_dir=args.trace_dir,
        device=device,
    )
    pipeline.run()
    return pipeline
