"""Interactive flow inspector (a cv2 window), its pure helpers and its
clip of (frame, flow) pairs.

Counterpart of extra/viewflow_player.py over the port: step through a
video or a ``.flow.zip`` frame by frame, look at the source frame, the
destination frame or the source reconstructed through the flow, overlay
the flow as an arrow grid or a magnitude heat map, zoom, and read the flow
vector under the mouse cursor. ``magnitude_image``, ``arrow_segments``,
``reconstruct`` and ``hud_lines`` are its numpy helpers, copied.
``FlowClip`` reads a ``.flow.zip`` through the port's ``FlowSource``, or a
video or an image sequence through ``utils/imageio.py``, and estimates a
pair's flow with the port's Farneback on its device (the card by
default). ``run_player`` needs cv2 and a display.

Keys:
  a / d      previous / next frame        space     play / pause
  1 / 2 / 3  source / destination / reconstructed view
  f          toggle arrow overlay         m         toggle magnitude overlay
  + / -      zoom in / out                q or ESC  quit

Usage:
  python -m transflow_tpu_torch.tools.viewflow_player video.mp4
  from transflow_tpu_torch.tools.viewflow_player import FlowClip
  FlowClip("frames/%04d.pgm").flow(0)
"""
import sys

import numpy as np

from ..utils.misc import require

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
    """Random-access (frame, flow) pairs from a ``.flow.zip``, a video or
    an image sequence. ``device``: where ``flow`` estimates a sequence's pairs, the
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
            sequence.close()
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


def run_player(path: str, arrow_step: int = 24, device=None):
    """The player's window over ``path`` until q or ESC; ``device`` as
    ``FlowClip``'s."""
    cv2 = require("cv2", "the flow player")
    clip = FlowClip(path, device=device)
    index, view, playing = 0, "reconstructed", False
    show_arrows, show_magnitude, zoom = True, False, 1.0
    cursor = [None]
    window = "viewflow"
    cv2.namedWindow(window, cv2.WINDOW_AUTOSIZE)

    def on_mouse(event, x, y, *_):
        cursor[0] = (int(x / zoom), int(y / zoom))

    cv2.setMouseCallback(window, on_mouse)
    while True:
        index = max(0, min(index, len(clip) - 1))
        flow = clip.flow(index)
        if view == "source":
            image = clip.frame(index).copy()
        elif view == "destination":
            image = clip.frame(index + 1).copy()
        else:
            image = reconstruct(clip.frame(index), flow)
        if show_magnitude:
            image = magnitude_image(flow)
        if show_arrows:
            for start, end in arrow_segments(flow, arrow_step):
                cv2.arrowedLine(image, start, end, (255, 255, 0), 1,
                                tipLength=0.3)
        for k, line in enumerate(hud_lines(index, len(clip), clip.framerate,
                                           flow, view, cursor[0])):
            cv2.putText(image, line, (8, 18 + 16 * k),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.45, (0, 255, 0), 1)
        if zoom != 1.0:
            image = cv2.resize(image, None, fx=zoom, fy=zoom,
                               interpolation=cv2.INTER_NEAREST)
        cv2.imshow(window, cv2.cvtColor(image, cv2.COLOR_RGB2BGR))
        key = cv2.waitKey(40 if playing else 0) & 0xFF
        if key in (27, ord("q")):
            break
        elif key == ord("d") or (playing and key == 255):
            index += 1
            if index >= len(clip):
                index, playing = len(clip) - 1, False
        elif key == ord("a"):
            index -= 1
        elif key == ord(" "):
            playing = not playing
        elif key == ord("1"):
            view = "source"
        elif key == ord("2"):
            view = "destination"
        elif key == ord("3"):
            view = "reconstructed"
        elif key == ord("f"):
            show_arrows = not show_arrows
        elif key == ord("m"):
            show_magnitude = not show_magnitude
        elif key in (ord("+"), ord("=")):
            zoom = min(8.0, zoom * 2)
        elif key == ord("-"):
            zoom = max(0.25, zoom / 2)
    cv2.destroyWindow(window)


if __name__ == "__main__":
    run_player(sys.argv[1])
