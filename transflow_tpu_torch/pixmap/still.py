"""Still (constant-frame) pixmap sources.

Counterpart of transflow_tpu/pixmap/still.py: the same generators, seeded
the same way, so the same seed gives the same pixels
(tests/test_torch_io.py). A still is put on the device once and reused
every frame (pipeline.py). Images are read by ``utils/imageio.py``.
"""
import random

import numpy as np

from ..utils import parse_color
from .base import PixmapSource


class StillPixmapSource(PixmapSource):

    def __init__(self, width: int | None = None, height: int | None = None,
                 seed: int | None = None, alteration_path: str | None = None):
        super().__init__(alteration_path, length=None)
        self.width = width
        self.height = height
        self.seed = seed
        self.array: np.ndarray | None = None

    def _init_array(self) -> np.ndarray:
        raise NotImplementedError

    def open(self):
        self.array = self._init_array()
        self.height, self.width = self.array.shape[:2]
        self.load_alteration()
        return self

    def __next__(self) -> np.ndarray:
        assert self.array is not None, "source not opened"
        return self.alter(self.array.copy())

    @property
    def is_constant(self) -> bool:
        """Constant-frame source: upload once, reuse on device."""
        return True


class ColorPixmapSource(StillPixmapSource):
    """Uniform color (random under the seed when unspecified)."""

    def __init__(self, width: int, height: int, color: str | None = None,
                 seed: int | None = None, alteration_path: str | None = None):
        super().__init__(width, height, seed, alteration_path)
        self.color = color

    def _init_array(self):
        if self.color is None:
            rng = np.random.default_rng(self.seed)
            color = rng.integers(0, 256, size=3, dtype=np.uint8)
        else:
            color = np.asarray(parse_color(self.color), dtype=np.uint8)
        return np.broadcast_to(
            color, (self.height, self.width, 3)).copy()


class NoisePixmapSource(StillPixmapSource):
    """Random grey noise."""

    def _init_array(self):
        rng = np.random.default_rng(self.seed)
        grey = rng.integers(0, 256, size=(self.height, self.width, 1),
                            dtype=np.uint8)
        return np.repeat(grey, 3, axis=2)


class BwNoisePixmapSource(StillPixmapSource):
    """Random black-or-white noise."""

    def _init_array(self):
        rng = np.random.default_rng(self.seed)
        bw = rng.choice(np.asarray([0, 255], dtype=np.uint8),
                        size=(self.height, self.width, 1))
        return np.repeat(bw, 3, axis=2)


class ColoredNoisePixmapSource(StillPixmapSource):
    """Random colored noise."""

    def _init_array(self):
        rng = np.random.default_rng(self.seed)
        return rng.integers(0, 256, size=(self.height, self.width, 3),
                            dtype=np.uint8)


class GradientPixmapSource(StillPixmapSource):
    """Random procedural gradient from an expression tree.

    Node types and sampling probabilities follow still.py:84-119; evaluation
    is vectorized (still.py:121-149 evaluates per pixel)."""

    NODE_I, NODE_J, NODE_RGB, NODE_MIX, NODE_TRIPLE, NODE_Z, NODE_B = range(7)

    def _generate(self, rng: random.Random, node_type: int, depth: int):
        if depth <= 0 and node_type != self.NODE_Z:
            return self._generate(rng, self.NODE_Z, 0)
        if node_type in (self.NODE_TRIPLE, self.NODE_MIX):
            return (node_type,
                    self._generate(rng, self.NODE_B, depth - 1),
                    self._generate(rng, self.NODE_B, depth - 1),
                    self._generate(rng, self.NODE_B, depth - 1))
        if node_type == self.NODE_B:
            if rng.random() < 0.25:
                return self._generate(rng, self.NODE_Z, depth - 1)
            return self._generate(rng, self.NODE_MIX, depth - 1)
        # leaf
        x = rng.random()
        if x < 1 / 3:
            return (self.NODE_I, None, None, None)
        if x < 2 / 3:
            return (self.NODE_J, None, None, None)
        return (self.NODE_RGB, rng.random() * 2 - 1, rng.random() * 2 - 1,
                rng.random() * 2 - 1)

    def _evaluate(self, tree, zi, zj) -> np.ndarray:
        """Return (H, W, 3) values in [-1, 1]."""
        node_type, a, b, c = tree
        if node_type == self.NODE_TRIPLE:
            return np.stack([self._evaluate(a, zi, zj)[..., 0],
                             self._evaluate(b, zi, zj)[..., 1],
                             self._evaluate(c, zi, zj)[..., 2]], axis=-1)
        if node_type == self.NODE_MIX:
            ea = self._evaluate(a, zi, zj)
            eb = self._evaluate(b, zi, zj)
            ec = self._evaluate(c, zi, zj)
            weight = (1 + ea) / 2
            return (1 - weight) * eb + weight * ec
        if node_type == self.NODE_RGB:
            out = np.empty((*zi.shape, 3), dtype=np.float32)
            out[..., 0], out[..., 1], out[..., 2] = a, b, c
            return out
        if node_type == self.NODE_I:
            return np.repeat(zi[..., None], 3, axis=2)
        if node_type == self.NODE_J:
            return np.repeat(zj[..., None], 3, axis=2)
        raise ValueError(f"Unknown node type {node_type}")

    def _init_array(self):
        rng = random.Random(self.seed)
        tree = self._generate(rng, self.NODE_TRIPLE, 5)
        zi = np.broadcast_to(
            (2 * np.arange(self.height, dtype=np.float32)
             / max(1, self.height - 1) - 1)[:, None],
            (self.height, self.width))
        zj = np.broadcast_to(
            (2 * np.arange(self.width, dtype=np.float32)
             / max(1, self.width - 1) - 1)[None, :],
            (self.height, self.width))
        values = self._evaluate(tree, zi, zj)
        return (255 * (values + 1) / 2).astype(np.uint8)


class ImagePixmapSource(StillPixmapSource):
    """Image file (keeps alpha when present)."""

    def __init__(self, path: str, alteration_path: str | None = None):
        super().__init__(alteration_path=alteration_path)
        self.path = path

    def _init_array(self):
        from ..utils.imageio import imread
        arr = imread(self.path)
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=2)
        if arr.shape[2] not in (3, 4):
            raise ValueError(
                f"Pixmap image has unsupported channels: {arr.shape}")
        return arr.copy()


class VideoStillPixmapSource(ImagePixmapSource):
    """First frame of a video (the 'first' keyword uses the flow input)."""

    def _init_array(self):
        from ..utils.imageio import open_sequence
        sequence = open_sequence(self.path)
        frame = sequence.read()
        sequence.close()
        if frame is None:
            raise ValueError(
                f"Could not read first frame of {self.path!r}")
        return frame.copy()
