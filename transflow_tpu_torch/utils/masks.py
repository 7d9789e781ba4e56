"""Mask DSL — small string language describing float/bool masks.

Counterpart of transflow_tpu/utils/masks.py, the same rules and numbers
(tests/test_torch_io.py pins them). Supported rules: ``zeros``, ``ones``,
``random``, ``border[-side]:<dims>``,
``hline:<h>``, ``vline:<w>``, ``circle:<r>``, ``rect:<w>[:<h>]``,
``grid:<rows>:<cols>:<r>``, an image path (luminance mapped to [0,1]), each
optionally suffixed with ``:inv`` to invert. Dimensions accept a ``%`` suffix
relative to the parent dimension.

Masks are built host-side with numpy once at setup and shipped to the
device. Image masks are read by ``utils/imageio.py``.
"""
import re
import warnings

import numpy as np

_BORDER_RE = re.compile(
    r"^border(\-(top|right|bottom|left))?:(\d+%?:|:|\d+%?$){1,4}$", re.IGNORECASE)
_LINE_RE = re.compile(r"^[hv]line:\d+%?$", re.IGNORECASE)
_CIRCLE_RE = re.compile(r"^circle:\d+%?", re.IGNORECASE)
_RECT_RE = re.compile(r"^rect:\d+%?(:\d+%?)?", re.IGNORECASE)
_GRID_RE = re.compile(r"^grid:\d+:\d+:\d+", re.IGNORECASE)


def _dim(arg: str, parent: int) -> int:
    arg = arg.strip()
    if arg == "":
        return 0
    if arg.endswith("%"):
        return int(float(arg[:-1]) / 100 * parent)
    return int(arg)


def _border_sizes(rule: str, height: int, width: int) -> tuple[int, int, int, int]:
    top = right = bottom = left = 0
    name, rest = rule.lower().split(":", 1)
    if name == "border":
        sizes = [_dim(a, height if i % 2 == 0 else width)
                 for i, a in enumerate(rest.split(":"))]
        if len(sizes) == 1:
            top = right = bottom = left = sizes[0]
        elif len(sizes) == 2:
            top = bottom = sizes[0]
            right = left = sizes[1]
        elif len(sizes) == 4:
            top, right, bottom, left = sizes
        else:
            raise ValueError(f"Border mask takes 1, 2 or 4 sizes, got {len(sizes)}")
    elif name == "border-top":
        top = _dim(rest, height)
    elif name == "border-right":
        right = _dim(rest, width)
    elif name == "border-bottom":
        bottom = _dim(rest, height)
    elif name == "border-left":
        left = _dim(rest, width)
    else:
        raise ValueError(f"Unknown border rule {name}")
    return top, right, bottom, left


def _disk(radius: int) -> np.ndarray:
    d = 2 * radius
    ii = np.arange(d)[:, None] - radius
    jj = np.arange(d)[None, :] - radius
    return (ii ** 2 + jj ** 2 < radius ** 2).astype(np.float32)


def _from_image(path: str) -> np.ndarray:
    from .imageio import imread
    arr = imread(path).astype(np.float32)
    if arr.ndim == 2:
        return arr / 255.0
    if arr.ndim == 3:
        if arr.shape[2] == 4:
            warnings.warn(f"Mask {path} has an alpha channel; it is ignored")
        return np.mean(arr[:, :, :3], axis=2) / 255.0
    raise ValueError(f"Mask image has {arr.ndim} dimensions, expected 2 or 3")


def load_float_mask(rule: str | None, shape: tuple[int, int] = (0, 0),
                    default: float = 0.0) -> np.ndarray:
    """Build a (H, W) float32 mask from a DSL rule string."""
    if rule is None:
        return np.full(shape, default, dtype=np.float32)
    inverse = rule.endswith(":inv")
    if inverse:
        rule = rule[:-4]
    lowered = rule.lower()
    height, width = shape
    if lowered == "zeros":
        arr = np.zeros(shape, dtype=np.float32)
    elif lowered == "ones":
        arr = np.ones(shape, dtype=np.float32)
    elif lowered == "random":
        arr = np.random.rand(*shape).astype(np.float32)
    elif _BORDER_RE.match(rule):
        top, right, bottom, left = _border_sizes(rule, height, width)
        arr = np.zeros(shape, dtype=np.float32)
        if top:
            arr[:top, :] = 1
        if right:
            arr[:, -right:] = 1
        if bottom:
            arr[-bottom:, :] = 1
        if left:
            arr[:, :left] = 1
    elif _LINE_RE.match(rule):
        name, arg = lowered.split(":")
        arr = np.zeros(shape, dtype=np.float32)
        if name == "hline":
            size = _dim(arg, height)
            i = (height - size) // 2
            arr[i:i + size, :] = 1
        else:
            size = _dim(arg, width)
            j = (width - size) // 2
            arr[:, j:j + size] = 1
    elif _CIRCLE_RE.match(rule):
        radius = _dim(lowered.split(":")[1], min(shape))
        ii = np.arange(height)[:, None] - height // 2
        jj = np.arange(width)[None, :] - width // 2
        arr = (ii ** 2 + jj ** 2 < radius ** 2).astype(np.float32)
    elif _RECT_RE.match(rule):
        args = rule[rule.index(":") + 1:].split(":")
        if len(args) == 1:
            rect_w = _dim(args[0], width)
            rect_h = _dim(args[0], height)
        elif len(args) == 2:
            rect_w = _dim(args[0], width)
            rect_h = _dim(args[1], height)
        else:
            raise ValueError(f"Rect mask takes 1 or 2 sizes, got {len(args)}")
        arr = np.ones(shape, dtype=np.float32)
        arr[:height // 2 - rect_h // 2, :] = 0
        arr[height // 2 + rect_h // 2:, :] = 0
        arr[:, :width // 2 - rect_w // 2] = 0
        arr[:, width // 2 + rect_w // 2:] = 0
    elif _GRID_RE.match(rule):
        nrows, ncols, radius = map(int, rule[rule.index(":") + 1:].split(":"))
        disk = _disk(radius)
        arr = np.zeros(shape, dtype=np.float32)
        cell_h, cell_w = height // nrows, width // ncols
        for r in range(nrows):
            for c in range(ncols):
                i0 = cell_h * r + cell_h // 2 - radius
                j0 = cell_w * c + cell_w // 2 - radius
                arr[i0:i0 + 2 * radius, j0:j0 + 2 * radius] = disk
    else:
        arr = _from_image(rule)
    if inverse:
        arr = 1.0 - arr
    return arr.astype(np.float32)


def load_bool_mask(rule: str | None, shape: tuple[int, int] = (0, 0),
                   default: bool = False) -> np.ndarray:
    """Build a (H, W) bool mask (rounded float mask)."""
    return np.round(load_float_mask(rule, shape, float(default))).astype(bool)
