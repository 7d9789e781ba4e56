"""Layer configuration of the port.

``transflow_tpu.config`` imports JAX (through ``transflow_tpu.utils``), so
the port re-declares what its slice needs: ``LayerConfig`` with the same
fields, defaults and dict round-trip (transflow_tpu/config.py:79-142).
tests/test_torch_model.py pins it to the original.
"""


def parse_bool_arg(arg, default: bool) -> bool:
    if arg is None:
        return default
    if isinstance(arg, str):
        return arg.lower().strip() in ("1", "on", "o", "oui", "yes", "y", "true")
    return bool(arg)


class LayerConfig:
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

    def todict(self) -> dict:
        return {key: getattr(self, key) for key, _ in self._FIELDS}

    @classmethod
    def fromdict(cls, d: dict):
        (required, _), *rest = cls._FIELDS
        return cls(d[required], **{k: d.get(k, dv) for k, dv in rest})
