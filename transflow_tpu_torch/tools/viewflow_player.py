"""Flow clip inspection: the frame-by-frame player's pure helpers and its
clip of (frame, flow) pairs.

Counterpart of extra/viewflow_player.py over the port. ``magnitude_image``,
``arrow_segments``, ``reconstruct`` and ``hud_lines`` are its numpy
helpers, copied. ``FlowClip`` reads a ``.flow.zip`` through the port's
``FlowSource`` or an image sequence through ``utils/imageio.py``, and
estimates a pair's flow with the port's Farneback on its device (the card
by default). The player itself, ``run_player``, is a cv2 window and
raises, as does a video file (both need ROADMAP item 14.2).

Usage (the clip from Python; the window is not ported):
  from transflow_tpu_torch.tools.viewflow_player import FlowClip
  FlowClip("frames/%04d.pgm").flow(0)
"""
import numpy as np

from ..utils.imageio import CODECS_NOT_PORTED

# magnitude heat colors (dark blue -> red), matching the reference's
# compute_magnitude lerp (player.py:91-97)
_COLD = np.array([0, 0, 106], np.float32)
_HOT = np.array([183, 49, 33], np.float32)


def magnitude_image(flow: np.ndarray) -> np.ndarray:
    """Flow -> RGB uint8 heat map: sqrt-compressed norm lerps two colors."""
    norm = np.linalg.norm(flow, axis=-1)
    m = np.clip(np.sqrt(norm) / 5.0, 0.0, 1.0)[..., None]
    return ((1.0 - m) * _COLD + m * _HOT).astype(np.uint8)


def arrow_segments(flow: np.ndarray, step: int = 24,
                   min_norm: float = 0.5) -> list:
    """Arrow (start, end) pixel pairs on a block grid, skipping still cells.

    Returns [((x0, y0), (x1, y1)), ...] for cells whose mean displacement
    exceeds ``min_norm``."""
    h, w = flow.shape[:2]
    segments = []
    for i in range(step // 2, h, step):
        for j in range(step // 2, w, step):
            block = flow[max(0, i - step // 2):i + step // 2,
                         max(0, j - step // 2):j + step // 2]
            dx, dy = float(block[..., 0].mean()), float(block[..., 1].mean())
            if dx * dx + dy * dy < min_norm * min_norm:
                continue
            segments.append(((j, i), (int(round(j + dx)),
                                      int(round(i + dy)))))
    return segments


def reconstruct(frame: np.ndarray, flow: np.ndarray) -> np.ndarray:
    """Scatter the source frame through the rounded flow.

    Matches the reference viewer's apply_flow (player.py:119-130): flat
    ``numpy.put`` with wrap-around index mode, last-write-wins in flat
    order."""
    arr = np.array(frame)
    height, width, depth = arr.shape
    rounded = np.round(flow).astype(int)
    base = np.arange(0, height * width * depth, dtype=int)
    flow_flat = rounded[:, :, 1] * width + rounded[:, :, 0]
    flow_flat = np.repeat(flow_flat, depth).astype(int) * depth
    np.put(arr, base + flow_flat, arr.flat, mode="wrap")
    return arr


def hud_lines(index: int, total, framerate: float, flow: np.ndarray,
              view: str, cursor=None) -> list:
    """Status lines for the on-screen HUD."""
    norm = np.linalg.norm(flow, axis=-1)
    t = index / framerate if framerate else 0.0
    lines = [
        f"frame {index}" + (f" / {total}" if total else "")
        + f"   t={t:.3f}s   view={view}",
        f"mean |f| {norm.mean():.3f}   max |f| {norm.max():.3f}   "
        f"moving {float(np.mean(norm > 0.5)):.1%}",
    ]
    if cursor is not None:
        x, y = cursor
        h, w = flow.shape[:2]
        if 0 <= y < h and 0 <= x < w:
            lines.append(f"({x},{y}) -> ({flow[y, x, 0]:+.2f}, "
                         f"{flow[y, x, 1]:+.2f})")
    return lines


class FlowClip:
    """Random-access (frame, flow) pairs from a ``.flow.zip`` or an image
    sequence. ``device``: where ``flow`` estimates a sequence's pairs, the
    current CUDA device by default."""

    def __init__(self, path: str, device=None):
        self.path = path
        self.device = device
        self.is_archive = path.endswith(".flow.zip")
        self._frames: list = []
        self._flows: list = []
        if self.is_archive:
            from ..flow.sources.base import FlowSource
            with FlowSource.from_args(path) as source:
                self.framerate = source.framerate
                for item in source:
                    self._flows.append(np.asarray(item.array))
            self.height, self.width = self._flows[0].shape[:2]
            # no imagery in an archive: show magnitude as the "frame"
            self._frames = [magnitude_image(f) for f in self._flows]
        else:
            from ..utils.imageio import open_sequence
            sequence = open_sequence(path)
            self.framerate = sequence.framerate
            while (frame := sequence.read()) is not None:
                self._frames.append(frame)
            if len(self._frames) < 2:
                raise ValueError("need at least 2 frames")
            self.height, self.width = self._frames[0].shape[:2]
            self._flows = [None] * (len(self._frames) - 1)

    def __len__(self):
        return len(self._flows)

    def frame(self, index: int) -> np.ndarray:
        return self._frames[min(index, len(self._frames) - 1)]

    def flow(self, index: int) -> np.ndarray:
        """The flow of pair ``index``: the archive's, or the port's
        Farneback (cv2's defaults) from frame ``index + 1`` back to frame
        ``index`` on the clip's device, as the JAX tool calls its own."""
        if self._flows[index] is None:
            import torch
            from .._device import resolve_device
            from ..flow.estimators import get_estimator
            device = resolve_device(self.device)
            est = get_estimator("farneback")
            gray0 = self._frames[index].mean(axis=2).astype(np.uint8)
            gray1 = self._frames[index + 1].mean(axis=2).astype(np.uint8)
            prev = torch.zeros((self.height, self.width, 2),
                               dtype=torch.float32, device=device)
            self._flows[index] = est(
                torch.from_numpy(gray1).to(device),
                torch.from_numpy(gray0).to(device), prev).cpu().numpy()
        return self._flows[index]


def run_player(path: str, arrow_step: int = 24):
    """extra/viewflow_player.py's cv2 window: raises."""
    raise NotImplementedError(
        f"the flow player is a cv2 window, {CODECS_NOT_PORTED}")
