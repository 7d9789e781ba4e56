"""Estimator selection and hyper-parameters of a frame source, and the
source that decodes frames for the device estimator.

Counterpart of transflow_tpu/flow/sources/cv.py: ``CvFlowConfig`` with the
same methods, defaults, validation, JSON round-trip and estimator kwargs,
and ``CvFlowSource``, which yields gray frames (RGB for LiteFlowNet) for
estimation on the device. It reads through ``utils/imageio.py``: an
image sequence in numpy (the frame count, frame rate and pixels of
``cv2.VideoCapture``), a video file or a camera through
``cv2.VideoCapture`` itself, as the JAX source does. ``show_window=True``
opens the live-tuning window (``gui/tuning.py``) when the source opens.
"""
import json

import numpy as np

from ...utils.imageio import open_sequence, resize_nearest
from .base import FlowItem, FlowSource

METHODS = ("farneback", "horn-schunck", "lukas-kanade", "liteflownet")


class CvFlowConfig:
    """Estimator selection + hyper-parameters, JSON round-trip."""

    DEFAULTS = dict(
        method="farneback",
        fb_pyr_scale=0.5, fb_levels=3, fb_winsize=15, fb_iterations=3,
        fb_poly_n=5, fb_poly_sigma=1.2, fb_flags=0, fb_downscale=1,
        fb_select_warp=0,
        hs_alpha=1.0, hs_iterations=3, hs_decay=0.0, hs_delta=1.0,
        lk_window_size=15, lk_max_level=2, lk_step=1,
        lfn_warp_bound=0, lfn_scale=1.0,
    )

    def __init__(self, show_window: bool = False, **kwargs):
        unknown = set(kwargs) - set(self.DEFAULTS)
        if unknown:
            raise ValueError(f"Unknown cv_config keys: {sorted(unknown)}")
        for key, default in self.DEFAULTS.items():
            setattr(self, key, kwargs.get(key, default))
        if self.method not in METHODS:
            raise ValueError(f"Unknown flow method {self.method!r}")
        if int(self.lfn_warp_bound) < 0:
            raise ValueError(
                f"lfn_warp_bound must be >= 0, got {self.lfn_warp_bound}")
        if not 0.0 < float(self.lfn_scale) <= 1.0:
            raise ValueError(
                f"lfn_scale must be in (0, 1], got {self.lfn_scale}")
        if int(self.fb_downscale) < 1:
            raise ValueError(
                f"fb_downscale must be >= 1, got {self.fb_downscale}")
        if int(self.fb_select_warp) < 0:
            raise ValueError(
                f"fb_select_warp must be >= 0, got {self.fb_select_warp}")
        self.show_window = show_window
        self.window = None
        self.version = 0  # bumped by update(); the engine rebuilds its step

    def start(self):
        """Open the live-tuning window where ``show_window`` asks for it."""
        if not self.show_window:
            return
        from ...gui.tuning import CvFlowConfigWindow
        self.window = CvFlowConfigWindow(self)
        self.window.start()

    def update(self, name, value):
        setattr(self, name, value)
        self.version += 1

    def to_dict(self) -> dict:
        return {key: getattr(self, key) for key in self.DEFAULTS}

    def to_file(self, path: str):
        with open(path, "w", encoding="utf8") as file:
            json.dump(self.to_dict(), file, indent=4)

    @classmethod
    def from_file(cls, path: str) -> "CvFlowConfig":
        with open(path, "r", encoding="utf8") as file:
            return cls(**json.load(file))

    def estimator_kwargs(self) -> dict:
        """Static kwargs for the device estimator (flow/estimators/)."""
        if self.method == "farneback":
            return dict(pyr_scale=self.fb_pyr_scale, levels=int(self.fb_levels),
                        winsize=int(self.fb_winsize),
                        iterations=int(self.fb_iterations),
                        poly_n=int(self.fb_poly_n),
                        poly_sigma=self.fb_poly_sigma,
                        flags=int(self.fb_flags),
                        downscale=int(self.fb_downscale),
                        select_warp=int(self.fb_select_warp))
        if self.method == "horn-schunck":
            return dict(alpha=self.hs_alpha, max_iters=int(self.hs_iterations),
                        decay=self.hs_decay, delta=self.hs_delta)
        if self.method == "lukas-kanade":
            return dict(win_size=int(self.lk_window_size),
                        max_level=int(self.lk_max_level),
                        step=int(self.lk_step))
        if self.method == "liteflownet":
            # the level-2 bound of the bounded backwarp (kernel A3), passed
            # even when 0 so the config overrides the environment fallback
            return dict(warp_bound=int(self.lfn_warp_bound),
                        scale=float(self.lfn_scale))
        return {}


class CvFlowSource(FlowSource):
    """An image sequence, a video file or a camera read frame by frame,
    yielding gray frames (RGB for LiteFlowNet) for the device
    estimator."""

    yields_frames = True

    def __init__(self, file: str, config: CvFlowConfig | None = None,
                 size: tuple[int, int] | None = None, **kwargs):
        super().__init__(**kwargs)
        self.file = file
        self.config = config if config is not None else CvFlowConfig()
        # the capture's requested size (a camera's --size); cv2 cannot
        # resize an image sequence or a file on read, so those keep theirs
        self.size = size
        self.capture = None
        self._primed = False

    def _open_reader(self):
        self.capture = open_sequence(self.file, self.size)
        self.width = self.capture.width
        self.height = self.capture.height
        self.framerate = float(self.capture.framerate)
        # N frames give N-1 flow steps; a single image has no length
        self.base_length = (None if self.capture.count is None
                            else self.capture.count - 1)
        self.config.start()

    def _decode(self) -> np.ndarray:
        gray = self.config.method != "liteflownet"
        frame = self.capture.read(gray=gray)
        if frame is None:
            raise StopIteration
        if frame.shape[1] != self.width or frame.shape[0] != self.height:
            frame = resize_nearest(frame, self.width, self.height)
        return frame

    # beyond this many frames, seek the container to the frame instead of
    # decoding the prefix again (a video's rewind is O(n) otherwise)
    FAST_SEEK_THRESHOLD = 300

    def _rewind_reader(self, frame_index: int):
        """Reposition so the PREVIOUS frame is frame_index (estimation pairs
        frames i and i+1); the next read yields a priming frame."""
        if self.capture is None:
            return
        if not (frame_index > self.FAST_SEEK_THRESHOLD
                and self.capture.seek_frame(frame_index)):
            self.capture.pos = frame_index
        self._primed = False

    def _read_item(self) -> FlowItem:
        prime = None
        if not self._primed:
            # the first frame after open/rewind re-seeds the estimator's
            # state; it is no output (a flow needs 2 frames)
            prime = self._decode()
            self._primed = True
        return FlowItem(FlowItem.FRAME, self._decode(), prime=prime)

    def _close_reader(self):
        if self.capture is not None:
            self.capture.close()
