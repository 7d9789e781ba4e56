"""Replay of a precomputed .flow.zip archive.

Counterpart of transflow_tpu/flow/sources/archive.py, the same reader:
meta.json (direction, width, height, framerate) and one %09d.npy per
frame. It needs only numpy and zipfile, so it runs wherever the port does.

* STORED members (what ``output/archive.py`` writes for dense float
  flows) are served zero-copy from one mmap of the file: the member's raw
  bytes are found from its local header and the frame is an
  ``np.frombuffer`` view (npy header versions 1.0 and 2.0; float32 arrays
  come back as read-only views, which every consumer only reads).
* DEFLATED members (integer ``--export-rounded-flow`` exports, archives of
  other writers) take whole-member reads, through a thread pool of
  ``min(4, cpu_count)`` workers with one ZipFile handle each, keyed by
  exact frame index so seek, repeat and checkpoint resume replay the same
  bytes; a lookahead of ``LOOKAHEAD`` frames bounds the cache.
  ``TRANSFLOW_ARCHIVE_THREADS`` overrides the pool size (0|1 =
  sequential).
* The three paths give the same arrays; the mmap path skips zipfile's
  CRC32 check. ``TRANSFLOW_ARCHIVE_MMAP=0`` reads stored members with
  ``zf.read`` instead.
"""
import concurrent.futures
import io
import json
import mmap
import os
import struct
import threading
import zipfile

import numpy as np

from .. import Direction
from .base import FlowItem, FlowSource

#: frames decoded ahead of the cursor; bounds the cache at
#: LOOKAHEAD x (H x W x 2 x itemsize) bytes (~133 MB at 1080p f32)
LOOKAHEAD = 8


def _stored_member_view(mm: mmap.mmap, info: zipfile.ZipInfo):
    """(offset, size) of a STORED member's raw bytes, from its local
    header (the central directory's name/extra lengths can differ from
    the local ones, so the local header is authoritative)."""
    header = mm[info.header_offset:info.header_offset + 30]
    if header[:4] != b"PK\x03\x04":
        return None
    name_len, extra_len = struct.unpack("<HH", header[26:30])
    offset = info.header_offset + 30 + name_len + extra_len
    return offset, info.file_size


def _npy_from_mmap(mm: mmap.mmap, offset: int, size: int):
    """Zero-copy array view over a STORED .npy member; None if the npy
    format is one we don't fast-path (fortran order, pickled objects,
    header versions beyond 2.0)."""
    fmt = np.lib.format
    buffer = io.BytesIO(bytes(mm[offset:offset + min(size, 4096)]))
    try:
        version = fmt.read_magic(buffer)
        if version == (1, 0):
            shape, fortran, dtype = fmt.read_array_header_1_0(buffer)
        elif version == (2, 0):
            shape, fortran, dtype = fmt.read_array_header_2_0(buffer)
        else:
            return None
    except ValueError:
        return None
    if fortran or dtype.hasobject:
        return None
    count = int(np.prod(shape, dtype=np.int64))
    return np.frombuffer(mm, dtype=dtype, count=count,
                         offset=offset + buffer.tell()).reshape(shape)


class ArchiveFlowSource(FlowSource):

    yields_frames = False

    def __init__(self, path: str, **kwargs):
        super().__init__(**kwargs)
        self.path = path
        self.archive: zipfile.ZipFile | None = None
        self._pool: concurrent.futures.ThreadPoolExecutor | None = None
        self._pending: dict[int, concurrent.futures.Future] = {}
        self._names: frozenset[str] = frozenset()
        self._tls = threading.local()
        self._handles: list[zipfile.ZipFile] = []
        self._handles_lock = threading.Lock()
        self._mmap: mmap.mmap | None = None
        self._mmap_file = None
        self._stored: dict[str, tuple[int, int]] = {}

    def _open_reader(self):
        self.archive = zipfile.ZipFile(self.path)
        with self.archive.open("meta.json") as file:
            meta = json.loads(file.read().decode())
        # archives carry their own direction (older ones were forward-only)
        self.direction = Direction(
            meta.get("direction", Direction.FORWARD.value))
        self.width = meta["width"]
        self.height = meta["height"]
        self.framerate = meta["framerate"]
        infos = [i for i in self.archive.infolist()
                 if i.filename.endswith(".npy")]
        self._names = frozenset(i.filename for i in infos)
        self.base_length = len(self._names)
        if os.environ.get("TRANSFLOW_ARCHIVE_MMAP", "1") != "0":
            stored = [i for i in infos
                      if i.compress_type == zipfile.ZIP_STORED
                      and not i.flag_bits & 0x1]  # not encrypted
            if stored:
                self._mmap_file = open(self.path, "rb")
                self._mmap = mmap.mmap(self._mmap_file.fileno(), 0,
                                       access=mmap.ACCESS_READ)
                for info in stored:
                    view = _stored_member_view(self._mmap, info)
                    if view is not None:
                        self._stored[info.filename] = view
        workers = int(os.environ.get("TRANSFLOW_ARCHIVE_THREADS",
                                     min(4, os.cpu_count() or 1)))
        if workers > 1 and len(self._stored) < len(self._names):
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=workers,
                thread_name_prefix="transflow-archive")

    def _rewind_reader(self, frame_index: int):
        pass  # random access by name; prefetch is keyed by exact index

    def _worker_zip(self) -> zipfile.ZipFile:
        handle = getattr(self._tls, "zip", None)
        if handle is None:
            handle = zipfile.ZipFile(self.path)
            self._tls.zip = handle
            with self._handles_lock:
                self._handles.append(handle)
        return handle

    def _load(self, index: int) -> np.ndarray:
        # whole-member read: ONE large inflate (GIL released) per frame
        return np.load(io.BytesIO(
            self._worker_zip().read(f"{index:09d}.npy")))

    def _read_item(self) -> FlowItem:
        index = self.input_frame_index
        name = f"{index:09d}.npy"
        if name not in self._names:
            raise StopIteration
        if name in self._stored:
            flow = _npy_from_mmap(self._mmap, *self._stored[name])
            if flow is not None:
                return FlowItem(FlowItem.FLOW,
                                flow.astype(np.float32, copy=False))
            # exotic npy (fortran/object/new header): slow-path this
            # member from now on so the prefetch loop below covers it
            del self._stored[name]
        if self._pool is None:
            flow = np.load(io.BytesIO(self.archive.read(name)))
            return FlowItem(FlowItem.FLOW, flow.astype(np.float32))
        # drop entries a seek/rewind left behind (stale indexes would pin
        # decoded frames for the rest of the run)
        window = self._upcoming(index)
        for stale in [i for i in self._pending if i not in window]:
            self._pending.pop(stale).cancel()
        for ahead in window:
            ahead_name = f"{ahead:09d}.npy"
            if (ahead not in self._pending and ahead_name in self._names
                    and ahead_name not in self._stored):
                self._pending[ahead] = self._pool.submit(self._load, ahead)
        flow = self._pending.pop(index).result()
        return FlowItem(FlowItem.FLOW, flow.astype(np.float32))

    def _upcoming(self, index: int) -> set[int]:
        """The next LOOKAHEAD frame indexes the reader will actually
        request: clamped at end_frame (a --duration cut must not decode
        past it) and wrapped to start_frame when the source repeats, so
        the pipeline stays warm across rewinds. On the final lap the
        wrap over-decodes at most LOOKAHEAD-1 frames, once."""
        out = set()
        i = index
        for _ in range(LOOKAHEAD):
            if i >= self.end_frame:
                if self.repeat == 1 or self.start_frame >= self.end_frame:
                    break
                i = self.start_frame
            out.add(i)
            i += 1
        return out

    def _close_reader(self):
        if self._pool is not None:
            # wait=True: a running inflate (~250 ms at 1080p) must finish
            # before its per-thread zip handle is closed underneath it
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None
        self._pending.clear()
        with self._handles_lock:
            for handle in self._handles:
                handle.close()
            self._handles.clear()
        if self.archive is not None:
            self.archive.close()
        self._stored.clear()
        if self._mmap is not None:
            try:
                self._mmap.close()
            except BufferError:
                pass  # frombuffer views still alive; GC reclaims later
            self._mmap = None
        if self._mmap_file is not None:
            self._mmap_file.close()
            self._mmap_file = None
