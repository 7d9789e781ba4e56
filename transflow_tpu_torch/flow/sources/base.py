"""Flow source base: seek/duration/repeat/lock bookkeeping (host side).

Counterpart of transflow_tpu/flow/sources/base.py, with the same item
kinds and arithmetic: a source yields raw items, either a frame for the
device estimator or a raw (H, W, 2) flow; post-processing is a device-side
function built from the source's options (``flow/transforms.py``). Lock
'stay' pauses the reader and replays the previous raw flow; 'skip' keeps
reading and drops the results it locks.

A subclass implements ``_open_reader`` (setting width, height, framerate
and base_length), ``_read_item`` and ``_rewind_reader``. ``from_args``
routes a path to its source as the JAX package does: a ``.flow.zip`` to
``ArchiveFlowSource``, ``--mv`` to ``MotionVectorFlowSource`` (the libav
shim's motion vectors), anything else to ``CvFlowSource``, which reads
image sequences (``utils/imageio.py``).
"""
import json
import logging
import os
from typing import Callable, Iterator, Optional

import numpy as np

from .. import Direction, LockMode
from ..transforms import make_postprocess
from ...utils import load_float_mask, parse_expression, parse_lock_intervals

logger = logging.getLogger(__name__)


class FlowItem:
    """One tick of a flow source."""
    __slots__ = ("kind", "array", "locked", "discarded", "prime")

    FRAME = "frame"  # uint8 frame -> estimator input
    FLOW = "flow"    # float32 (H, W, 2) raw flow
    REPLAY = "replay"  # lock: reuse previous raw flow

    def __init__(self, kind: str, array=None, locked: bool = False,
                 discarded: "FlowItem | None" = None, prime=None):
        self.kind = kind
        self.array = array
        self.locked = locked
        # lock 'skip': the raw item read and dropped underneath the lock;
        # frame-based estimators still consume it to stay continuous
        self.discarded = discarded
        # frame that re-seeds estimator state (first frame after open/rewind)
        self.prime = prime


class FlowSource:
    """Iterator over FlowItems with seek/duration/repeat/lock logic."""

    yields_frames = False  # True when items are frames needing estimation

    def __init__(self,
                 direction: Direction = Direction.FORWARD,
                 mask_path: str | None = None,
                 kernel_path: str | None = None,
                 flow_filters: str | None = None,
                 seek_ckpt: int | None = None,
                 seek_time: float | None = None,
                 duration_time: float | None = None,
                 repeat: int = 1,
                 lock_expr: str | None = None,
                 lock_mode=LockMode.STAY):
        self.direction = Direction.from_arg(direction)
        self.mask_path = mask_path
        self.kernel_path = kernel_path
        self.flow_filters = flow_filters
        self.seek_ckpt = seek_ckpt
        self.seek_time = seek_time
        self.duration_time = duration_time
        self.repeat = repeat
        self.lock_mode = LockMode.from_arg(lock_mode)
        self.lock_expr = lock_expr
        # filled by open()
        self.width: int = 0
        self.height: int = 0
        self.framerate: float = 30.0
        self.base_length: int | None = None
        self.is_stream = False
        self.start_frame = 0
        self.ckpt_start_frame = 0
        self.end_frame = 0
        self.length: int | None = None
        self.input_frame_index = 0
        self.output_frame_index = 0
        self.lock_intervals = None
        self.lock_interval_index = 0
        self.lock_skip_fn: Optional[Callable] = None
        self.lock_start: float | None = None
        # output frames rendered before this instance (checkpoint resume):
        # keeps the lock timeline t continuous across resumes
        self.t_base_frames = 0
        self._opened = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------

    def _open_reader(self):
        """Open the underlying media; set width/height/framerate/base_length."""
        raise NotImplementedError

    def _close_reader(self):
        pass

    def _read_item(self) -> FlowItem:
        """Read the next raw item; raise StopIteration at end of media."""
        raise NotImplementedError

    def _rewind_reader(self, frame_index: int):
        """Reposition the reader so the next read yields ``frame_index``."""
        raise NotImplementedError

    def open(self):
        """Two-phase init (base.py::FlowSource.open)."""
        self._open_reader()
        if self.lock_expr is not None:
            if self.lock_mode == LockMode.STAY:
                self.lock_intervals = parse_lock_intervals(self.lock_expr)
            else:
                self.lock_skip_fn = parse_expression(self.lock_expr)
        if self.base_length is not None and self.base_length <= 0:
            self.base_length = None
        self.is_stream = self.base_length is None
        if self.is_stream and self.repeat > 1:
            logger.warning("Flow source is a stream, cannot repeat it")
            self.repeat = 1
        if self.is_stream and self.seek_time:
            logger.warning("Flow source is a stream, seek time is ignored")
            self.seek_time = None
        if self.seek_time is not None and not self.is_stream:
            self.start_frame = int(self.seek_time * self.framerate)
        else:
            self.start_frame = 0
        if self.duration_time is not None:
            self.end_frame = self.start_frame + int(
                round(self.duration_time * self.framerate, 3))
            if self.base_length is not None:
                self.end_frame = min(self.end_frame, self.base_length)
        elif self.base_length is not None:
            self.end_frame = self.base_length
        if self.repeat == 0:
            self.length = None
        elif self.is_stream:
            self.length = self.end_frame
        else:
            self.length = self.repeat * (self.end_frame - self.start_frame)
        if (self.length is not None and self.lock_mode == LockMode.STAY
                and self.lock_intervals is not None):
            for _, lock_duration in self.lock_intervals:
                self.length += int(lock_duration * self.framerate)
        # Checkpoint resume: position the input at start + cursor (wrapping
        # inside the repeat span) and shorten the remaining output length.
        self.ckpt_start_frame = self.start_frame
        if self.seek_ckpt is not None:
            span = max(1, self.end_frame - self.start_frame)
            if (self.lock_mode == LockMode.STAY
                    and self.lock_intervals is not None):
                # a lock-stay frame consumes no input: replay the lock
                # bookkeeping of the rendered outputs to find the input
                # position and the interval cursor
                consumed = 0
                for _ in range(self.seek_ckpt):
                    if not self._locked():
                        consumed += 1
                    self.output_frame_index += 1
                self.output_frame_index = 0
                self.ckpt_start_frame += consumed % span
            else:
                # no lock, or lock-skip (one input per output either way)
                self.ckpt_start_frame += self.seek_ckpt % span
            # t keeps counting across the resume so time-positioned locks
            # do not fire again
            self.t_base_frames = self.seek_ckpt
            if self.length is not None:
                self.length = max(0, self.length - self.seek_ckpt)
        self.rewind(self.ckpt_start_frame)
        self._opened = True
        return self

    def __enter__(self):
        return self.open()

    def __exit__(self, *exc):
        self._close_reader()

    def close(self):
        self._close_reader()

    # ------------------------------------------------------------------
    # iteration
    # ------------------------------------------------------------------

    @property
    def t(self) -> float:
        return (0.0 if not self.framerate
                else (self.t_base_frames + self.output_frame_index)
                / self.framerate)

    def rewind(self, frame_index: int | None = None):
        if frame_index is None:
            frame_index = self.start_frame
        self.input_frame_index = frame_index
        self._rewind_reader(frame_index)

    def _read_with_loop(self) -> FlowItem:
        if self.input_frame_index == self.end_frame:
            self.rewind()
        item = self._read_item()
        self.input_frame_index += 1
        return item

    def _locked(self) -> bool:
        """Lock bookkeeping (base.py::FlowSource._locked)."""
        if self.lock_mode == LockMode.STAY and self.lock_intervals is not None:
            if self.lock_interval_index >= len(self.lock_intervals):
                return False
            was_locked = self.lock_start is not None
            locked = False
            if was_locked:
                elapsed = self.t - self.lock_start
                locked = elapsed < self.lock_intervals[
                    self.lock_interval_index][1]
                if not locked:
                    self.lock_interval_index += 1
                    self.lock_start = None
                    if self.lock_interval_index >= len(self.lock_intervals):
                        return False
            if not was_locked or not locked:
                locked = self.t >= self.lock_intervals[
                    self.lock_interval_index][0]
                if locked:
                    self.lock_start = self.t
            return locked
        if self.lock_mode == LockMode.SKIP and self.lock_skip_fn is not None:
            return bool(self.lock_skip_fn(self.t))
        return False

    def __next__(self) -> FlowItem:
        if (self.length is not None
                and self.output_frame_index >= self.length):
            raise StopIteration
        locked = self._locked()
        if locked:
            if self.output_frame_index == 0:
                raise RuntimeError(
                    "Flow is locked but has not been initialized. "
                    "Maybe lock the flow later?")
            discarded = None
            if self.lock_mode == LockMode.SKIP:
                # the stream advances underneath the lock
                try:
                    discarded = self._read_with_loop()
                except StopIteration:
                    discarded = None
            item = FlowItem(FlowItem.REPLAY, locked=True, discarded=discarded)
        else:
            item = self._read_with_loop()
        self.output_frame_index += 1
        return item

    def __iter__(self) -> Iterator[FlowItem]:
        return self

    def __len__(self):
        return self.length

    # ------------------------------------------------------------------
    # device-side post-process builder
    # ------------------------------------------------------------------

    def build_postprocess(self, device=None):
        """The source's post-process on ``device`` (the current CUDA
        device by default). A mask rule is loaded at the source's size
        (DSL rules need it; an image carries its own), a kernel with
        ``np.load``; both go to the device once, here."""
        mask = None
        if self.mask_path is not None:
            mask = load_float_mask(self.mask_path, (self.height, self.width))
        kernel = None
        if self.kernel_path is not None:
            kernel = np.load(self.kernel_path)
        return make_postprocess(self.flow_filters, mask, kernel,
                                self.direction, device=device)

    # ------------------------------------------------------------------
    # factory
    # ------------------------------------------------------------------

    @classmethod
    def from_args(cls,
                  flow_path: str,
                  use_mvs: bool = False,
                  mask_path: str | None = None,
                  kernel_path: str | None = None,
                  cv_config: str | None = None,
                  flow_filters: str | None = None,
                  size: tuple[int, int] | None = None,
                  direction=None,
                  seek_ckpt: int | None = None,
                  seek_time: float | None = None,
                  duration_time: float | None = None,
                  repeat: int = 1,
                  lock_expr: str | None = None,
                  lock_mode=LockMode.STAY) -> "FlowSource":
        """Route to the concrete source (FlowSource.from_args of the JAX
        package)."""
        if "::" in flow_path:
            avformat, file = flow_path.split("::")
        else:
            avformat, file = None, flow_path
        kwargs = dict(direction=direction, mask_path=mask_path,
                      kernel_path=kernel_path, flow_filters=flow_filters,
                      seek_ckpt=seek_ckpt, seek_time=seek_time,
                      duration_time=duration_time, repeat=repeat,
                      lock_expr=lock_expr, lock_mode=lock_mode)
        if file.endswith(".flow.zip"):
            from .archive import ArchiveFlowSource
            return ArchiveFlowSource(file, **kwargs)
        if use_mvs:
            from .mv import MotionVectorFlowSource
            return MotionVectorFlowSource(file, avformat, **kwargs)
        from .cv import CvFlowConfig, CvFlowSource
        if isinstance(cv_config, dict):
            config = CvFlowConfig(**cv_config)
        elif cv_config is not None and os.path.isfile(cv_config):
            config = CvFlowConfig.from_file(cv_config)
        elif cv_config == "window":
            config = CvFlowConfig(show_window=True)
        elif isinstance(cv_config, str) and cv_config.lstrip().startswith("{"):
            config = CvFlowConfig(**json.loads(cv_config))
        elif cv_config is not None:
            raise FileNotFoundError(
                f"cv_config {cv_config!r} is neither a file, 'window', nor "
                "inline JSON")
        else:
            config = CvFlowConfig()
        return CvFlowSource(file, config, size, **kwargs)
