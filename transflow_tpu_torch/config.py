"""Configuration tree of the port.

``transflow_tpu.config`` imports JAX (through ``transflow_tpu.utils``), so
the port re-declares it: ``PixmapSourceConfig``, ``LayerConfig`` and
``Config`` with the same fields, defaults, validation and dict round-trip
(transflow_tpu/config.py), and ``Config.get_secondary_output_path``.
tests/test_torch_model.py, tests/test_torch_sources.py and
tests/test_torch_cli.py pin them to the originals.
"""
import os
import random
import re
import sys
import time

from .flow import Direction, LockMode
from .utils import parse_size, parse_timestamp

_MJPEG_RE = re.compile(r"^mjpeg(:[:a-z0-9A-Z\-]+)?$", re.IGNORECASE)
_SUFFIX_RE = re.compile(r".*\.(\d{3})$")


def parse_bool_arg(arg, default: bool) -> bool:
    if arg is None:
        return default
    if isinstance(arg, str):
        return arg.lower().strip() in ("1", "on", "o", "oui", "yes", "y", "true")
    return bool(arg)


class _DictSchema:
    """Dict round-trip derived from ``_FIELDS``: ``(key, default)`` rows
    where every key is both the JSON name and the attribute name, the first
    row is the single required positional, and ``default`` is what
    ``fromdict`` feeds the constructor when the key is absent."""

    _FIELDS: tuple = ()

    def todict(self) -> dict:
        return {key: getattr(self, key) for key, _ in self._FIELDS}

    @classmethod
    def fromdict(cls, d: dict):
        (required, _), *rest = cls._FIELDS
        return cls(d[required], **{k: d.get(k, dv) for k, dv in rest})


class PixmapSourceConfig(_DictSchema):
    """One pixmap source bound to one or more layers."""

    _FIELDS = (
        ("path", None),
        ("seek_time", None),
        ("alteration_path", None),
        ("introduction_path", None),
        ("repeat", 1),
        ("layers", None),
    )

    def __init__(self,
                 path: str,
                 seek_time: float | str | None = None,
                 alteration_path: str | None = None,
                 introduction_path: str | None = None,
                 repeat: int | None = 1,
                 layers: list[int] | None = None):
        self.path = path
        self.seek_time = parse_timestamp(seek_time)
        self.alteration_path = alteration_path
        self.introduction_path = introduction_path
        self.repeat = 1 if repeat is None else repeat
        self.layers = [0] if layers is None else layers


class LayerConfig(_DictSchema):
    """One compositor layer: class, movement flags, reset and introduction
    rules."""

    CLASSNAMES = ("moveref", "introduction", "static", "sum")

    _FIELDS = tuple((key, None) for key in (
        "index", "classname", "mask_src", "mask_dst", "mask_alpha",
        "transparent_pixels_can_move", "pixels_can_move_to_empty_spot",
        "pixels_can_move_to_filled_spot", "moving_pixels_leave_empty_spot",
        "reset_mode", "reset_mask", "reset_random_factor",
        "reset_constant_step", "reset_linear_factor", "reset_source",
        "introduce_pixels_on_empty_spots", "introduce_pixels_on_filled_spots",
        "introduce_moving_pixels", "introduce_unmoving_pixels",
        "introduce_once", "introduce_on_all_filled_spots",
        "introduce_on_all_empty_spots"))

    def __init__(self,
                 index: int,
                 classname: str | None = None,
                 mask_alpha: str | None = None,
                 mask_src: str | None = None,
                 mask_dst: str | None = None,
                 transparent_pixels_can_move=None,
                 pixels_can_move_to_empty_spot=None,
                 pixels_can_move_to_filled_spot=None,
                 moving_pixels_leave_empty_spot=None,
                 reset_mode: str | None = None,
                 reset_mask: str | None = None,
                 reset_random_factor: float | None = None,
                 reset_constant_step: float | None = None,
                 reset_linear_factor: float | None = None,
                 reset_source=None,
                 introduce_pixels_on_empty_spots=None,
                 introduce_pixels_on_filled_spots=None,
                 introduce_moving_pixels=None,
                 introduce_unmoving_pixels=None,
                 introduce_once=None,
                 introduce_on_all_filled_spots=None,
                 introduce_on_all_empty_spots=None):
        self.index = index
        self.classname = "moveref" if classname is None else classname
        self.mask_alpha = mask_alpha
        self.mask_src = mask_src
        self.mask_dst = mask_dst
        self.transparent_pixels_can_move = parse_bool_arg(transparent_pixels_can_move, False)
        self.pixels_can_move_to_empty_spot = parse_bool_arg(pixels_can_move_to_empty_spot, True)
        self.pixels_can_move_to_filled_spot = parse_bool_arg(pixels_can_move_to_filled_spot, True)
        self.moving_pixels_leave_empty_spot = parse_bool_arg(moving_pixels_leave_empty_spot, False)
        self.reset_mode = "off" if reset_mode is None else reset_mode
        self.reset_mask = reset_mask
        self.reset_random_factor = 1 if reset_random_factor is None else reset_random_factor
        self.reset_constant_step = 1 if reset_constant_step is None else reset_constant_step
        self.reset_linear_factor = 0.1 if reset_linear_factor is None else reset_linear_factor
        self.reset_source = parse_bool_arg(reset_source, False)
        self.introduce_pixels_on_empty_spots = parse_bool_arg(introduce_pixels_on_empty_spots, True)
        self.introduce_pixels_on_filled_spots = parse_bool_arg(introduce_pixels_on_filled_spots, True)
        self.introduce_moving_pixels = parse_bool_arg(introduce_moving_pixels, True)
        self.introduce_unmoving_pixels = parse_bool_arg(introduce_unmoving_pixels, True)
        self.introduce_once = parse_bool_arg(introduce_once, False)
        self.introduce_on_all_filled_spots = parse_bool_arg(introduce_on_all_filled_spots, False)
        self.introduce_on_all_empty_spots = parse_bool_arg(introduce_on_all_empty_spots, False)


class Config(_DictSchema):
    """Top-level render configuration (flow + pixmaps + layers + outputs)."""

    _FIELDS = (
        # flow
        ("flow_path", None),
        ("extra_flow_paths", None),
        ("flows_merging_function", "first"),
        ("use_mvs", False),
        ("mask_path", None),
        ("kernel_path", None),
        ("cv_config", None),
        ("flow_filters", None),
        ("direction", "forward"),
        ("seek_time", None),
        ("duration_time", None),
        ("repeat", 1),
        ("lock_expr", None),
        ("lock_mode", None),
        # pixmaps + compositor (nested fields overridden below)
        ("pixmap_sources", None),
        ("layers", None),
        ("compositor_background", None),
        # outputs
        ("output_path", None),
        ("vcodec", "h264"),
        ("size", None),
        ("view_flow", False),
        ("view_flow_magnitude", False),
        ("render_scale", 1),
        ("render_colors", None),
        ("render_binary", False),
        # general + device layout
        ("seed", None),
        ("batch_frames", None),
        ("mesh", None),
        ("halo", None),
    )

    def __init__(self,
                 flow_path: str,
                 extra_flow_paths: list[str] | None = None,
                 flows_merging_function: str = "first",
                 use_mvs: bool = False,
                 mask_path: str | None = None,
                 kernel_path: str | None = None,
                 cv_config: str | None = None,
                 flow_filters: str | None = None,
                 direction="forward",
                 seek_time=None,
                 duration_time=None,
                 to_time=None,
                 repeat: int = 1,
                 lock_expr: str | None = None,
                 lock_mode=None,
                 pixmap_sources: list[PixmapSourceConfig] | None = None,
                 layers: list[LayerConfig] | None = None,
                 compositor_background: str | None = None,
                 output_path=None,
                 vcodec: str = "h264",
                 size=None,
                 view_flow: bool = False,
                 view_flow_magnitude: bool = False,
                 render_scale: float = 1,
                 render_colors=None,
                 render_binary: bool = False,
                 seed: int | None = None,
                 batch_frames: int | None = None,
                 mesh: str | None = None,
                 halo: int | None = None):
        # Flow args
        self.flow_path = flow_path
        self.extra_flow_paths = [] if extra_flow_paths is None else extra_flow_paths
        self.flows_merging_function = flows_merging_function
        if not self.extra_flow_paths:
            self.flows_merging_function = "first"
        self.use_mvs = use_mvs
        self.mask_path = mask_path
        self.kernel_path = kernel_path
        self.cv_config = cv_config
        self.flow_filters = flow_filters
        self.direction = Direction.from_arg(direction)
        parsed_seek = parse_timestamp(seek_time)
        self.seek_time: float = 0 if parsed_seek is None else parsed_seek
        parsed_duration = parse_timestamp(duration_time)
        parsed_to = parse_timestamp(to_time)
        if parsed_to is not None:
            self.duration_time = parsed_to - self.seek_time
        else:
            self.duration_time = parsed_duration
        if self.duration_time is not None and self.duration_time < 0:
            raise ValueError(f"Duration must be positive (got {self.duration_time})")
        self.repeat = repeat
        self.lock_expr = lock_expr
        self.lock_mode = LockMode.from_arg(lock_mode)

        # Pixmap args
        self.pixmap_sources = [] if pixmap_sources is None else pixmap_sources

        # Compositor args
        self.layers = [] if layers is None else layers
        layer_indices = set()
        for layer in self.layers:
            if layer.index in layer_indices:
                raise ValueError(f"Duplicate layer index {layer.index}")
            layer_indices.add(layer.index)
        for pixmap_config in self.pixmap_sources:
            for layer_index in pixmap_config.layers:
                if layer_index not in layer_indices:
                    self.layers.append(LayerConfig(layer_index))
                    layer_indices.add(layer_index)
        self.compositor_background = (
            "#ffffff" if compositor_background is None else compositor_background)

        # Output args
        self.output_path = (
            None if (isinstance(output_path, list) and not output_path)
            else output_path)
        self.vcodec = vcodec
        self.size = parse_size(size)
        self.view_flow = view_flow
        self.view_flow_magnitude = view_flow_magnitude
        self.render_scale = render_scale
        if isinstance(render_colors, str):
            render_colors = tuple(render_colors.split(","))
        elif isinstance(render_colors, list):
            render_colors = tuple(render_colors)
        self.render_colors = render_colors
        self.render_binary = render_binary

        # General args
        self.seed: int = random.randint(0, 2 ** 32 - 1) if seed is None else seed
        # frames per chunk (None = auto) and the multi-device layout (mesh
        # size or "STREAMxSPACE", halo rows); the port's Engine takes a
        # one-axis SpaceMesh and a halo (parallel/mesh.py)
        self.batch_frames = batch_frames
        self.mesh = mesh
        self.halo = halo

    @classmethod
    def fromdict(cls, d: dict) -> "Config":
        kwargs = {k: d.get(k, dv) for k, dv in cls._FIELDS[1:]}
        kwargs.update(
            to_time=d.get("to_time"),  # constructor-only: folds into duration
            pixmap_sources=[PixmapSourceConfig.fromdict(x)
                            for x in d.get("pixmap_sources") or []],
            layers=[LayerConfig.fromdict(x) for x in d.get("layers") or []])
        return cls(d["flow_path"], **kwargs)

    def todict(self) -> dict:
        d = super().todict()
        d.update(
            direction=self.direction.value,
            lock_mode=self.lock_mode.value,
            pixmap_sources=[x.todict() for x in self.pixmap_sources],
            layers=[x.todict() for x in self.layers],
            # provenance extras (ignored by fromdict)
            timestamp=time.time(),
            command={"executable": sys.executable, "argv": sys.argv})
        return d

    def get_secondary_output_path(self, suffix: str) -> str:
        """The .flow.zip/.ckpt.zip/.config.json sibling of the first
        output that is not an MJPEG stream (else of the flow path), with
        a ``.NNN`` uniqueness suffix stripped."""
        base_output_path = None
        if isinstance(self.output_path, list):
            for path in self.output_path:
                if _MJPEG_RE.match(path):
                    continue
                base_output_path = path
                break
        else:
            base_output_path = self.output_path
        path = os.path.splitext(
            self.flow_path if base_output_path is None else base_output_path)[0]
        if path.endswith(".flow") or path.endswith(".ckpt"):
            path = path[:-5]
        if _SUFFIX_RE.match(path):
            path = path[:-4]
        return path + suffix
