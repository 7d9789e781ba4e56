"""Host pipeline of the port: decode threads -> device engine -> readback
and encode threads.

Counterpart of transflow_tpu/pipeline.py, with the same setup, chunked and
per-frame loops, checkpoints (``meta.json`` + ``state.npz`` in a
``.ckpt.zip``, so each package resumes the other's), flow export,
config export, cancel and status queue. Where they differ:

* PyTorch runs eagerly, and a ``.cpu()`` readback of each rendered frame
  would stall the host until the card finishes it. So the main thread
  only issues work: frames and pixmaps go up through pinned buffers with
  ``non_blocking=True``, and the rendered frames and flows come down into
  pinned buffers the same way, with a CUDA event recorded after them. A
  readback thread waits on that event, writes the ``-F`` archive and feeds
  the encode threads, in order. The Pipeline adds no host sync of its own
  to a frame; the decode threads read frame t+1 while the card renders
  frame t. Threads hand numpy arrays over; all device work stays on the
  main thread.
* A short last chunk runs through ``Engine.process_chunk`` like any other:
  an eager chunk has no per-shape compile to avoid, and its random draws,
  timestamps and frame numbers are those of the same frames one by one.
* ``--mesh N`` on the CPU shards over N views of the CPU
  (``SpaceMesh(["cpu"] * N)``); on the card over the first N cards.
* A preview window (no ``-o``, or ``-O``) opens on the main thread, as
  cv2's HighGUI needs, and the main thread feeds it each frame once the
  frame's copy to the host is done: a host sync a frame, which only a
  window adds. A window keeps the render per frame, as in the JAX
  package.
"""
import dataclasses
import itertools
import json
import logging
import logging.config
import pathlib
import queue
import threading
import time
import zipfile
from typing import Optional

import numpy as np
import torch

try:
    from tqdm import tqdm
except ImportError:  # pragma: no cover
    tqdm = None

from ._device import resolve_device
from .compositor.core import make_layer_params
from .config import Config
from .engine import Engine
from .flow import Direction
from .flow.filters import static_clip_bound
from .flow.sources.base import FlowItem, FlowSource
from .output.archive import NumpyArchiveOutput, ZipOutput
from .output.video_output import VideoOutput
from .parallel import SpaceMesh, make_space_mesh, parse_mesh_spec
from .pixmap.base import PixmapSource
from .profiling import StageTimers, device_trace
from .utils import load_bool_mask
from .utils.imageio import resize_nearest

logger = logging.getLogger(__name__)

# how long a hand-over between threads may wait before it checks that the
# other side is still alive
_POLL = 0.2


class _SourceThread(threading.Thread):
    """Decode thread with a bounded queue (backpressure)."""

    SENTINEL = None

    def __init__(self, iterator, maxsize: int = 2, name: str = "source"):
        super().__init__(daemon=True, name=name)
        self.iterator = iterator
        self.queue: queue.Queue = queue.Queue(maxsize=maxsize)
        self.error: Exception | None = None
        self._stop_event = threading.Event()

    def run(self):
        try:
            for item in self.iterator:
                if self._stop_event.is_set():
                    return
                while True:
                    try:
                        self.queue.put(item, timeout=_POLL)
                        break
                    except queue.Full:
                        if self._stop_event.is_set():
                            return
        except Exception as err:  # noqa: BLE001 — reported to the main loop
            self.error = err
            logger.exception("Source thread failed")
        finally:
            # the end-of-stream sentinel, until the reader stops: a reader
            # that stopped with the queue full reads no more (waiting 5 s
            # on it, as the JAX thread does, held every close 5 s)
            while not self._stop_event.is_set():
                try:
                    self.queue.put(self.SENTINEL, timeout=_POLL)
                    break
                except queue.Full:
                    pass

    def get(self, poll: float = 1.0):
        """Block until an item arrives; fail only if the decode thread
        died without delivering its end-of-stream sentinel."""
        while True:
            try:
                item = self.queue.get(timeout=poll)
                break
            except queue.Empty:
                if not self.is_alive() and self.queue.empty():
                    if self.error is not None:
                        raise self.error
                    raise RuntimeError(
                        f"{self.name} thread died without a sentinel")
        if item is self.SENTINEL:
            if self.error is not None:
                raise self.error
            raise StopIteration
        return item

    def stop(self):
        self._stop_event.set()


class _ConsumerThread(threading.Thread):
    """A thread that consumes a bounded queue until its sentinel;
    ``feed`` raises the thread's error, and waits while the queue is full
    only as long as the thread lives."""

    SENTINEL = None

    def __init__(self, name: str, maxsize: int = 2):
        super().__init__(daemon=True, name=name)
        self.queue: queue.Queue = queue.Queue(maxsize=maxsize)
        self.error: BaseException | None = None

    def consume(self, item):
        raise NotImplementedError

    def opened(self):
        pass

    def closed(self):
        pass

    def run(self):
        try:
            self.opened()
            while True:
                item = self.queue.get()
                if item is self.SENTINEL:
                    break
                self.consume(item)
        except Exception as err:  # noqa: BLE001 — raised by feed/finish
            self.error = err
            logger.exception("%s thread failed", self.name)
        finally:
            try:
                self.closed()
            except Exception as err:  # noqa: BLE001
                self.error = self.error or err
                logger.exception("%s close failed", self.name)

    def feed(self, item):
        while True:
            if self.error is not None:
                raise self.error
            if not self.is_alive():
                raise RuntimeError(f"{self.name} thread is not running")
            try:
                self.queue.put(item, timeout=_POLL)
                return
            except queue.Full:
                continue

    def finish(self, timeout: float = 60.0):
        """Send the sentinel, wait for the thread, raise its error."""
        if self.is_alive():
            self.feed(self.SENTINEL)
            self.join(timeout)
            if self.is_alive():
                raise RuntimeError(f"{self.name} thread did not finish "
                                   f"within {timeout} s")
        if self.error is not None:
            raise self.error


class _OutputThread(_ConsumerThread):
    """Encode thread: one per output, fed host frames in order."""

    def __init__(self, output: VideoOutput, timers: StageTimers):
        super().__init__("output")
        self.output = output
        self.timers = timers

    def opened(self):
        self.output.open()

    def consume(self, frame):
        with self.timers.stage("encode"):
            self.output.feed(frame)

    def closed(self):
        self.output.close()


class _ReadbackThread(_ConsumerThread):
    """Waits for each batch of rendered frames (and flows) to land in host
    memory, then writes the flows to the ``-F`` archive and feeds every
    encode thread, in order. An item is (event or None, (K, H, W, 3)
    frames, (K, H, W, 2) flows or None), numpy views of pinned buffers
    that the event's copies fill."""

    def __init__(self, pipeline: "Pipeline"):
        super().__init__("readback")
        self.pipeline = pipeline

    def consume(self, item):
        event, frames, flows = item
        timers = self.pipeline.timers
        if event is not None:
            with timers.stage("readback"):
                event.synchronize()
        if flows is not None:
            with timers.stage("flow_export"):
                for flow in flows:
                    if self.pipeline.round_flow:
                        flow = np.round(flow).astype(int)
                    self.pipeline.flow_output.write_array(flow)
        for frame in frames:
            for thread in self.pipeline.output_threads:
                thread.feed(frame)


class Pipeline:
    """An end-to-end render over the port's Engine: sources, Engine,
    outputs."""

    @dataclasses.dataclass
    class Status:
        cursor: int
        total: int | None
        elapsed: float
        error: str | None

    def __init__(self,
                 cfg: Config,
                 safe: bool = False,
                 checkpoint_every: int | None = None,
                 checkpoint_end: bool = False,
                 execute: bool = False,
                 replace: bool = False,
                 export_config: bool = True,
                 export_flow: bool = False,
                 round_flow: bool = False,
                 preview_output: bool = False,
                 log_level: str = "DEBUG",
                 log_handler: str = "null",
                 log_path: pathlib.Path = pathlib.Path("transflow.log"),
                 cancel_event: Optional[threading.Event] = None,
                 status_queue=None,
                 progress: bool = True,
                 profile: bool = False,
                 trace_dir: str | None = None,
                 device=None):
        """``device``: where the render runs, the current CUDA device by
        default (no card raises); ``"cpu"`` runs it on the CPU."""
        self.config = cfg
        self.safe = safe
        self.checkpoint_every = checkpoint_every
        self.checkpoint_end = checkpoint_end or safe
        self.execute = execute
        self.replace = replace
        self.export_config = export_config or safe
        self.export_flow = export_flow
        self.round_flow = round_flow
        self.preview_output = preview_output
        self.log_level = log_level
        self.log_handler = log_handler
        self.log_path = pathlib.Path(log_path)
        self.cancel_event = cancel_event
        self.status_queue = status_queue
        self.progress = progress and tqdm is not None
        self.profile = profile
        self.trace_dir = trace_dir
        self.requested_device = device
        self.device: torch.device | None = None
        self.timers = StageTimers()

        self.flow_sources: list[FlowSource] = []
        self.flow_threads: list[_SourceThread] = []
        self.pixmap_sources: list[PixmapSource] = []
        self.pixmap_threads: list[Optional[_SourceThread]] = []
        self.output_threads: list[_OutputThread] = []
        self.window_outputs: list = []  # fed on the main thread (cv2 GUI)
        self.readback: _ReadbackThread | None = None
        self.flow_output: NumpyArchiveOutput | None = None
        self.engine: Engine | None = None
        self.ckpt_meta: dict = {}
        self.ckpt_arrays: dict = {}
        self.cursor = 0
        self.fs_width = self.fs_height = 0
        self.fs_framerate: float = 30.0
        self.fs_length: int | None = None
        self.bs_framerate: float | None = None
        self.bs_length: int | None = None
        self.width_factor = 1
        self.height_factor = 1
        # per-layer-position pixmap bindings: the pixmap indexes of each
        self._layer_bindings: list[list[int]] = []
        self._pix_peek: dict = {}
        # per pixmap: its device tensor, host copy and frame number
        self._pix_current: list = []
        self._pix_host: list = []
        self._pix_frame_no: list[int] = []
        self._pix_constant: list[bool] = []

    # ------------------------------------------------------------------

    @property
    def has_output(self) -> bool:
        return (bool(self.config.pixmap_sources) or self.config.view_flow
                or self.config.view_flow_magnitude)

    @property
    def expected_length(self) -> int | None:
        lengths = [x for x in (self.fs_length, self.bs_length)
                   if x is not None]
        return min(lengths) if lengths else None

    # ------------------------------------------------------------------
    # host <-> device
    # ------------------------------------------------------------------

    def _upload(self, arrays) -> torch.Tensor:
        """Host arrays of one shape, stacked on the Engine's device. On the
        card they are copied once, into one pinned buffer, which goes up
        with ``non_blocking=True``: no host sync (the caching host
        allocator keeps the buffer until its copy is done)."""
        device = self.engine.device
        if device.type != "cuda":
            return torch.from_numpy(np.stack(arrays))
        first = np.asarray(arrays[0])
        staged = torch.empty((len(arrays), *first.shape),
                             dtype=_torch_dtype(first.dtype), pin_memory=True)
        host = staged.numpy()
        for k, array in enumerate(arrays):
            host[k] = array
        return staged.to(device, non_blocking=True)

    def _upload_item(self, item: FlowItem) -> FlowItem:
        """A decoded item with its arrays (and its discarded item's) on the
        device."""
        return FlowItem(
            item.kind,
            None if item.array is None else self._upload([item.array])[0],
            locked=item.locked,
            discarded=(None if item.discarded is None
                       else self._upload_item(item.discarded)),
            prime=(None if item.prime is None
                   else self._upload([item.prime])[0]))

    def _read_back(self, frames: torch.Tensor, flows):
        """Start copying (K, H, W, 3) frames and, when flows are exported,
        (K, H, W, 2) flows to the host, and hand them to the readback
        thread, which waits for the copies."""
        export = self.flow_output is not None
        if frames.device.type != "cuda":
            item = (None, frames.numpy(), flows.numpy() if export else None)
        else:
            host_frames = _pinned_copy(frames)
            host_flows = _pinned_copy(flows) if export else None
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(frames.device))
            item = (event, host_frames.numpy(),
                    None if host_flows is None else host_flows.numpy())
        self.readback.feed(item)
        if self.window_outputs:
            if item[0] is not None:
                with self.timers.stage("readback"):
                    item[0].synchronize()
            for frame in item[1]:
                for window in self.window_outputs:
                    window.feed(frame)

    # ------------------------------------------------------------------
    # setup
    # ------------------------------------------------------------------

    def _setup_logging(self):
        handlers = [h.strip() for h in self.log_handler.split(",")]
        config: dict = {
            "version": 1,
            "disable_existing_loggers": False,
            "formatters": {"default": {
                "format": "%(asctime)s %(levelname)s %(name)s %(message)s"}},
            "handlers": {},
            "root": {"level": self.log_level, "handlers": []},
        }
        if "file" in handlers:
            self.log_path.parent.mkdir(parents=True, exist_ok=True)
            config["handlers"]["file"] = {
                "class": "logging.FileHandler", "filename": str(self.log_path),
                "formatter": "default"}
            config["root"]["handlers"].append("file")
        if "stream" in handlers:
            config["handlers"]["stream"] = {
                "class": "logging.StreamHandler", "formatter": "default"}
            config["root"]["handlers"].append("stream")
        if not config["root"]["handlers"]:
            # no handlers requested: leave the logging configuration of an
            # embedding program alone
            return
        logging.config.dictConfig(config)

    def _setup_checkpoint(self):
        """Resume from a .ckpt.zip action (of either package)."""
        action = self.config.flow_path
        if not action.endswith(".ckpt.zip"):
            return
        with zipfile.ZipFile(action) as archive:
            with archive.open("meta.json") as file:
                self.ckpt_meta = json.loads(file.read().decode())
            with archive.open("state.npz") as file:
                loaded = np.load(file)
                self.ckpt_arrays = {k: loaded[k] for k in loaded.files}
        # sources reposition themselves through seek_ckpt (FlowSource.open);
        # the original seek and duration stay, so repeat spans survive
        self.config = Config.fromdict(self.ckpt_meta["config"])
        self.cursor = 0  # relative to the resumed run; absolute = base+cursor

    def _setup_flow_sources(self):
        paths = [self.config.flow_path] + list(self.config.extra_flow_paths)
        seek_ckpt = self.ckpt_meta.get("cursor")
        for path in paths:
            source = FlowSource.from_args(
                path,
                use_mvs=self.config.use_mvs,
                mask_path=self.config.mask_path,
                kernel_path=self.config.kernel_path,
                cv_config=self.config.cv_config,
                flow_filters=self.config.flow_filters,
                size=self.config.size,
                direction=self.config.direction,
                seek_ckpt=seek_ckpt,
                seek_time=self.config.seek_time,
                duration_time=self.config.duration_time,
                repeat=self.config.repeat,
                lock_expr=self.config.lock_expr,
                lock_mode=self.config.lock_mode,
            )
            source.open()
            self.flow_sources.append(source)
        main = self.flow_sources[0]
        self.fs_width, self.fs_height = main.width, main.height
        self.fs_framerate = main.framerate
        self.fs_length = main.length
        for source in self.flow_sources[1:]:
            if (source.width, source.height) != (self.fs_width,
                                                 self.fs_height):
                raise ValueError("Extra flow sources must match the main "
                                 "flow's resolution")

    def _setup_pixmap_sources(self):
        for pix_cfg in self.config.pixmap_sources:
            source = PixmapSource.from_args(
                pix_cfg.path,
                (self.fs_width, self.fs_height),
                seek=self.ckpt_meta.get("cursor"),
                seed=self.config.seed,
                seek_time=pix_cfg.seek_time,
                alteration_path=pix_cfg.alteration_path,
                repeat=pix_cfg.repeat,
                flow_path=self.config.flow_path,
            )
            source.open()
            self.pixmap_sources.append(source)
            if source.length is not None:
                if self.bs_length is None or source.length < self.bs_length:
                    self.bs_length = source.length
            if source.framerate:
                self.bs_framerate = source.framerate
        if self.pixmap_sources:
            bs_width = max(s.width for s in self.pixmap_sources)
            bs_height = max(s.height for s in self.pixmap_sources)
            if (bs_width, bs_height) != (self.fs_width, self.fs_height):
                if (bs_width % self.fs_width or bs_height % self.fs_height):
                    raise ValueError(
                        f"Resolutions do not match: flow is "
                        f"{self.fs_width}x{self.fs_height} while pixmap is "
                        f"{bs_width}x{bs_height}.")
                self.width_factor = bs_width // self.fs_width
                self.height_factor = bs_height // self.fs_height

    def _setup_engine(self):
        out_h = self.fs_height * self.height_factor
        out_w = self.fs_width * self.width_factor
        # bind pixmaps to layers: sources_by_layer[cfg.index] =
        # [(channels, introduction_mask)], in pixmap declaration order
        sources_by_layer: dict = {}
        bindings: dict = {}
        for pix_idx, pix_cfg in enumerate(self.config.pixmap_sources):
            peek = next(self.pixmap_sources[pix_idx])
            self._pix_peek[pix_idx] = peek
            mask = load_bool_mask(pix_cfg.introduction_path, (out_h, out_w),
                                  True)
            for layer_index in pix_cfg.layers:
                sources_by_layer.setdefault(layer_index, []).append(
                    (peek.shape[2], mask))
                bindings.setdefault(layer_index, []).append(pix_idx)
        mesh, halo = self._build_mesh(out_h)
        layer_params = make_layer_params(
            self.config.layers, out_h, out_w, sources_by_layer,
            device=self.device)
        self._layer_bindings = [bindings.get(cfg.index, [])
                                for cfg in self.config.layers]
        self.engine = Engine(self.config, self.flow_sources, layer_params,
                             out_h, out_w, self.width_factor,
                             self.height_factor,
                             export_flows=self.export_flow,
                             mesh=mesh, halo=halo, device=self.device)
        self.engine._framerate = self.fs_framerate
        if self.ckpt_arrays:
            self.engine.load_state_arrays(self.ckpt_arrays)
        count = len(self.pixmap_sources)
        self._pix_current = [None] * count
        self._pix_host = [None] * count
        self._pix_frame_no = [-1] * count
        self._pix_constant = [getattr(s, "is_constant", False)
                              for s in self.pixmap_sources]
        for pix_idx, peek in self._pix_peek.items():
            self._push_pixmap(pix_idx, peek)

    def _build_mesh(self, out_h: int):
        """--mesh/--halo: the ``space`` mesh of this render and its halo.

        Returns (mesh, halo). Without --halo, the halo derives from a
        constant clip filter (scaled by the pixmap's upscale factor, which
        multiplies displacements); without either, the movement gather
        reads the whole state, with a warning."""
        halo = self.config.halo
        if halo is not None and halo < 0:
            raise ValueError(f"--halo {halo}: must be >= 0")
        if not self.config.mesh:
            if halo is not None:
                bound = static_clip_bound(self.config.flow_filters)
                if bound is None or bound > halo:
                    logger.warning(
                        "--halo %d without --mesh clamps every movement to "
                        "%d rows; pair it with a trailing clip<=%d flow "
                        "filter (or drop it on single-device runs)",
                        halo, halo, halo)
            return None, halo
        stream, space = parse_mesh_spec(self.config.mesh)
        if stream != 1:
            raise ValueError(
                f"--mesh {self.config.mesh}: the CLI pipeline renders one "
                "stream; use STREAM=1")
        if space <= 1:
            return None, halo
        if out_h % space or self.fs_height % space:
            raise ValueError(
                f"--mesh {self.config.mesh}: height {self.fs_height} "
                f"(output {out_h}) must divide by the space axis {space}")
        if self.device.type == "cpu":
            mesh = SpaceMesh([self.device] * space)
        else:
            mesh = make_space_mesh(space)
        if halo is None:
            bound = static_clip_bound(self.config.flow_filters)
            # merging can amplify per-source bounds (a sum of N clipped
            # flows reaches N*K): derive only for one flow source or a
            # merge that never amplifies
            merge_ok = (len(self.config.extra_flow_paths) == 0
                        or self.config.flows_merging_function
                        in ("first", "average", "absmax"))
            if (bound is not None and bound >= 0
                    and self.config.kernel_path is None and merge_ok):
                halo = int(np.ceil(bound * max(1, self.height_factor)))
                logger.info("mesh: derived halo=%d from the clip filter",
                            halo)
            else:
                logger.warning(
                    "--mesh without --halo and no post-chain constant "
                    "displacement bound (need a trailing clip=K filter, no "
                    "kernel, and a non-amplifying merge): movement gathers "
                    "read the full state every frame; pass --halo K to "
                    "force the bounded path")
        return mesh, halo

    def _prep_pixmap_frame(self, frame: np.ndarray) -> np.ndarray:
        out_h = self.fs_height * self.height_factor
        out_w = self.fs_width * self.width_factor
        if frame.shape[0] != out_h or frame.shape[1] != out_w:
            frame = resize_nearest(frame, out_w, out_h)
        return frame

    def _push_pixmap(self, pix_idx: int, frame: np.ndarray):
        frame = self._prep_pixmap_frame(frame)
        self._pix_host[pix_idx] = frame  # chunk stacking reads host copies
        self._pix_current[pix_idx] = self._upload([frame])[0]
        self._pix_frame_no[pix_idx] += 1

    def _setup_flow_export(self):
        if not self.export_flow:
            return
        path = self.config.get_secondary_output_path(".flow.zip")
        meta = {
            # exported flows are post-processed, i.e. already a backward
            # mapping: stamped so, a replay only re-clips them and
            # reproduces the run exactly
            "direction": Direction.BACKWARD.value,
            "width": self.fs_width * self.width_factor,
            "height": self.fs_height * self.height_factor,
            "framerate": self.fs_framerate,
        }
        self.flow_output = NumpyArchiveOutput(path, meta, self.replace)

    def _setup_outputs(self):
        self.readback = _ReadbackThread(self)
        self.readback.start()
        if not self.has_output:
            return
        out_w = self.fs_width * self.width_factor
        out_h = self.fs_height * self.height_factor
        framerate = (self.bs_framerate if self.bs_framerate
                     else self.fs_framerate)
        paths: list[str | None] = []
        if isinstance(self.config.output_path, list):
            paths += self.config.output_path
        else:
            paths.append(self.config.output_path)
        if self.config.output_path is not None and self.preview_output:
            paths.append(None)
        for path in paths:
            output = VideoOutput.from_args(
                path, out_w, out_h, framerate, self.config.vcodec,
                self.execute, self.replace,
                initial_counter=self.ckpt_meta.get("cursor", 0))
            if self.export_config and output.output_path is not None:
                config_path = pathlib.Path(
                    output.output_path).with_suffix(".config.json")
                with config_path.open("w") as file:
                    json.dump(self.config.todict(), file)
            from .output.window import WindowOutput
            if isinstance(output, WindowOutput):
                # cv2's HighGUI runs on the main thread: opened here, fed
                # by _read_back
                output.open()
                self.window_outputs.append(output)
                continue
            thread = _OutputThread(output, self.timers)
            thread.start()
            self.output_threads.append(thread)

    def _setup(self):
        self._setup_logging()
        self.device = resolve_device(self.requested_device)
        self._setup_checkpoint()
        if not (self.has_output or self.export_flow or self.checkpoint_end):
            logger.warning("No output or exportation selected")
        self._setup_flow_sources()
        self._setup_pixmap_sources()
        self._setup_engine()
        self._setup_flow_export()
        self._setup_outputs()
        for source in self.flow_sources:
            thread = _SourceThread(source, name="flow-decode")
            thread.start()
            self.flow_threads.append(thread)
        for pix_idx, source in enumerate(self.pixmap_sources):
            if self._pix_constant[pix_idx]:
                self.pixmap_threads.append(None)
            else:
                thread = _SourceThread(source, name="pixmap-decode")
                thread.start()
                self.pixmap_threads.append(thread)

    # ------------------------------------------------------------------
    # checkpoints
    # ------------------------------------------------------------------

    def export_checkpoint(self):
        assert self.engine is not None
        base_cursor = self.ckpt_meta.get("cursor", 0) + self.cursor
        output = ZipOutput(
            self.config.get_secondary_output_path(
                f"_{base_cursor:05d}.ckpt.zip"), self.replace)
        output.write_meta({
            # the ABSOLUTE cursor: a checkpoint of a resumed run must seek
            # sources to base + cursor, not just this run's frame count
            "config": self.config.todict(),
            "cursor": base_cursor,
            "framerate": self.fs_framerate,
            "timestamp": time.time(),
        })
        output.write_arrays("state.npz", self.engine.state_arrays())
        output.close()
        logger.debug("Exported checkpoint at cursor %d", self.cursor)
        return output.path

    # ------------------------------------------------------------------
    # main loop
    # ------------------------------------------------------------------

    def _gather_pixmaps(self):
        """Advance video pixmaps one frame; build the engine's args."""
        for pix_idx, thread in enumerate(self.pixmap_threads):
            if thread is None:
                continue  # constant source: the device copy persists
            if self._pix_frame_no[pix_idx] < self.cursor:
                self._push_pixmap(pix_idx, thread.get())
        pixmaps = tuple(
            tuple(self._pix_current[i] for i in binding)
            for binding in self._layer_bindings)
        # each source's frame counter advances once per output frame, so
        # constant sources track the cursor too
        frames = tuple(
            tuple(self.cursor if self._pix_constant[i]
                  else self._pix_frame_no[i] for i in binding)
            for binding in self._layer_bindings)
        return pixmaps, frames

    def _emit_status(self, started: float, error: str | None = None):
        if self.status_queue is None:
            return
        status = Pipeline.Status(self.cursor, self.expected_length,
                                 time.time() - started, error)
        try:
            self.status_queue.put(status, block=False)
        except queue.Full:
            pass

    #: frames per chunk when --batch-frames is unset and the render can be
    #: chunked
    AUTO_BATCH = 16

    @property
    def _batch_size(self) -> int:
        """Frames per ``Engine.process_chunk`` call. Chunks need no lock
        expression, no stream (webcam) source, no tuning window and no
        preview window (a chunk of K frames would add K frames of
        latency); any mix
        of frame and flow sources and of still and video pixmaps chunks.
        ``--batch-frames 1`` forces the per-frame loop, ``--batch-frames
        K`` picks the chunk size; chunked output is bit-equal to per-frame
        (tested)."""
        batch = self.config.batch_frames
        if batch is None:
            batch = self.AUTO_BATCH
        if batch <= 1:
            return 1
        if self.config.lock_expr is not None:
            return 1
        for source in self.flow_sources:
            if source.is_stream:
                return 1
            if getattr(getattr(source, "config", None), "show_window",
                       False):
                return 1
        if self.window_outputs:
            return 1
        return batch

    def _stack_pixmap_chunks(self, count: int):
        """Pull video-pixmap frames covering cursors [cursor, cursor+count).

        Returns ({pix_idx: K (H, W, C) frames}, K) with K <= count: a
        video pixmap that ends (no repeat) cuts the chunk, as the
        per-frame loop stops there."""
        chunks: dict[int, list] = {}
        for pix_idx, thread in enumerate(self.pixmap_threads):
            if thread is None:
                continue  # constant source: persistent device copy
            frames = []
            for k in range(count):
                fno = self.cursor + k
                if self._pix_frame_no[pix_idx] < fno:
                    try:
                        frame = thread.get()
                    except StopIteration:
                        count = k
                        break
                    self._pix_host[pix_idx] = self._prep_pixmap_frame(frame)
                    self._pix_frame_no[pix_idx] += 1
                frames.append(self._pix_host[pix_idx])
            chunks[pix_idx] = frames
        return {i: f[:count] for i, f in chunks.items()}, count

    def _mainloop_batched(self, started, total, bar, batch):
        """Chunked loop: stack K decoded frames per source, one
        ``process_chunk`` call. Sources advance in lockstep (one row = one
        item from every source); a rewind prime landing mid-chunk in any
        source flushes the chunk at that row, so every estimator chain
        resets at a chunk boundary."""
        timers = self.timers
        n_sources = len(self.flow_threads)
        const_pixmaps = tuple(
            tuple(self._pix_current[i] if self._pix_constant[i] else None
                  for i in binding)
            for binding in self._layer_bindings)
        done = False
        pending = None  # the item row whose prime flushed a chunk (repeat)

        def apply_primes(row):
            for src_idx, item in enumerate(row):
                if item.prime is not None:
                    self.engine.runtimes[src_idx].reset(
                        self._upload([item.prime])[0])

        while not done:
            if total is not None and self.cursor >= total:
                break
            if self.cancel_event is not None and self.cancel_event.is_set():
                break
            rows = []  # one entry per frame: per-source arrays
            with timers.stage("decode_wait"):
                want = batch if total is None else min(
                    batch, total - self.cursor)
                if self.checkpoint_every:
                    # chunks end at checkpoint boundaries, so
                    # --checkpoint-every fires at exact cursors
                    want = min(want, self.checkpoint_every
                               - self.cursor % self.checkpoint_every)
                if pending is not None:
                    apply_primes(pending)
                    rows.append([item.array for item in pending])
                    pending = None
                while len(rows) < want:
                    row = []
                    for thread in self.flow_threads:
                        try:
                            row.append(thread.get())
                        except StopIteration:
                            # any source ending ends the run; the row is
                            # dropped whole, as in the per-frame loop
                            done = True
                            break
                    if done:
                        break
                    if any(item.prime is not None for item in row):
                        if rows:
                            # a rewind landed mid-chunk (repeat): flush
                            pending = row
                            break
                        apply_primes(row)
                    rows.append([item.array for item in row])
                chunk_map, avail = self._stack_pixmap_chunks(len(rows))
                if avail < len(rows):
                    rows = rows[:avail]
                    done = True
                    pending = None
            if not rows:
                break
            with timers.stage("device_step"):
                pix_chunks = tuple(
                    tuple(None if self._pix_constant[i]
                          else self._upload(chunk_map[i]) for i in binding)
                    for binding in self._layer_bindings)
                source_chunks = [
                    self._upload([row[src_idx] for row in rows])
                    for src_idx in range(n_sources)]
                base = self.ckpt_meta.get("cursor", 0) + self.cursor
                # frame numbers are run-relative, as in the per-frame loop
                # (_gather_pixmaps); t is absolute likewise
                frames, flows = self.engine.process_chunk(
                    source_chunks, const_pixmaps, pix_chunks, base,
                    self.cursor)
                self._read_back(frames, flows)
            previous_cursor = self.cursor
            self.cursor += len(rows)
            if bar is not None:
                bar.update(len(rows))
            if (self.checkpoint_every and
                    self.cursor // self.checkpoint_every
                    > previous_cursor // self.checkpoint_every):
                with timers.stage("checkpoint"):
                    self.export_checkpoint()
            self._emit_status(started)
        if self.checkpoint_end and self.engine is not None:
            with timers.stage("checkpoint"):
                self.export_checkpoint()

    def _mainloop_frames(self, started, total, bar):
        """Per-frame loop: one ``process_frame`` call per frame."""
        timers = self.timers
        while True:
            if total is not None and self.cursor >= total:
                break
            if self.cancel_event is not None and self.cancel_event.is_set():
                logger.info("Cancelled")
                break
            try:
                with timers.stage("decode_wait"):
                    items = [thread.get() for thread in self.flow_threads]
                    pixmaps, frame_numbers = self._gather_pixmaps()
            except StopIteration:
                break
            t = (self.ckpt_meta.get("cursor", 0) + self.cursor) \
                / self.fs_framerate
            with timers.stage("device_step"):
                frame, flow = self.engine.process_frame(
                    [self._upload_item(item) for item in items], pixmaps, t,
                    frame_numbers)
                self._read_back(frame[None], flow[None])
            self.cursor += 1
            if bar is not None:
                bar.update(1)
            if (self.checkpoint_every
                    and self.cursor % self.checkpoint_every == 0):
                with timers.stage("checkpoint"):
                    self.export_checkpoint()
            self._emit_status(started)
        if self.checkpoint_end and self.engine is not None:
            with timers.stage("checkpoint"):
                self.export_checkpoint()

    def _mainloop(self):
        started = time.time()
        total = self.expected_length
        bar = tqdm(total=total, unit="frame") if self.progress else None
        batch = self._batch_size
        try:
            with device_trace(self.trace_dir):
                if batch > 1:
                    self._mainloop_batched(started, total, bar, batch)
                else:
                    self._mainloop_frames(started, total, bar)
                with self.timers.stage("flush"):
                    self._finish_outputs()
        finally:
            if bar is not None:
                bar.close()
            self._emit_profile()

    def _emit_profile(self):
        """--profile: print the stage table and write
        <output>.profile.json."""
        if not self.profile:
            return
        print(self.timers.format_table())
        try:
            self.timers.dump(self.config.get_secondary_output_path(
                ".profile.json"))
        except OSError:
            logger.exception("profile dump failed")

    def _finish_outputs(self):
        """Wait until every rendered frame is written; raise the first
        error of the readback and encode threads."""
        if self.readback is not None:
            self.readback.finish()
        for thread in self.output_threads:
            thread.finish()

    def _close(self):
        for thread in self.flow_threads:
            thread.stop()
        for thread in self.pixmap_threads:
            if thread is not None:
                thread.stop()
        for thread in ([self.readback] if self.readback else []) \
                + self.output_threads:
            try:
                thread.finish()
            except Exception:  # noqa: BLE001 — run() raised already
                logger.exception("%s thread failed at close", thread.name)
        for window in self.window_outputs:
            try:
                window.close()
            except Exception:  # noqa: BLE001
                logger.exception("Window close failed")

        # join each decode thread BEFORE closing its source: a thread still
        # reading when its source closes would report a spurious failure
        def _close_after(thread, source):
            if thread is not None:
                thread.join(timeout=10)
                if thread.is_alive():
                    logger.warning("%s thread still running at close; "
                                   "leaving its source open", thread.name)
                    return
            source.close()
        # zip_longest: an early _setup failure leaves sources without
        # threads, which must still close
        for thread, source in itertools.zip_longest(self.flow_threads,
                                                    self.flow_sources):
            if source is not None:
                _close_after(thread, source)
        for thread, source in itertools.zip_longest(self.pixmap_threads,
                                                    self.pixmap_sources):
            if source is not None:
                _close_after(thread, source)
        if self.flow_output is not None:
            self.flow_output.close()

    def run(self):
        error: BaseException | None = None
        started = time.time()
        try:
            with self.timers.stage("setup"):
                self._setup()
            self._mainloop()
        except (Exception, KeyboardInterrupt) as err:  # noqa: BLE001
            error = err
            logger.exception("Pipeline failed")
            if self.safe and self.engine is not None:
                try:
                    path = self.export_checkpoint()
                    logger.info("Safe-mode checkpoint written to %s", path)
                except Exception:  # noqa: BLE001
                    logger.exception("Safe-mode checkpoint failed")
                config_path = "last-config.json"
                with open(config_path, "w") as file:
                    json.dump(self.config.todict(), file)
            self._emit_status(started, error=str(err))
        finally:
            self._close()
        if error is not None and not isinstance(error, KeyboardInterrupt):
            raise error
        self._emit_status(started)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, dtype=dtype)).dtype


def _pinned_copy(tensor: torch.Tensor) -> torch.Tensor:
    """A pinned host tensor that a non-blocking copy of ``tensor`` fills."""
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor, non_blocking=True)
    return host
