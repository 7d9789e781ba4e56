"""H.264/H.265 motion-vector flow source (decode-side flow, no estimator).

Counterpart of transflow_tpu/flow/sources/mv.py: decode with
``+export_mvs`` and rasterize each frame's macroblock motion vectors into
a dense (H, W, 2) float32 field, on the host, as the JAX package does.

One backend: the repo's prebuilt libav shim through the port's own
binding (``av_native.MvReader``). The JAX source tries PyAV first; the
port has no PyAV backend, since neither the machine with the card nor the
test machine has PyAV, and the shim reads the same ``AVMotionVector``
records PyAV wraps.
"""
import numpy as np

from .base import FlowItem, FlowSource


class MotionVectorFlowSource(FlowSource):

    yields_frames = False

    def __init__(self, file: str, avformat: str | None = None, **kwargs):
        super().__init__(**kwargs)
        self.file = file
        self.avformat = avformat
        self.reader = None

    def _open_reader(self):
        from ... import av_native
        try:
            if not av_native.is_available():
                raise RuntimeError("native libav shim did not load: "
                                   f"{av_native.load_error()}")
            self.reader = av_native.MvReader(self.file,
                                             format=self.avformat)
        except (RuntimeError, OSError) as err:
            if isinstance(err, FileNotFoundError):
                raise
            raise ImportError(
                "Motion-vector flow extraction (--mv) requires PyAV or the "
                "native libav shim (make -C native libtransflow_av.so); "
                f"neither is available: {err}") from err
        self.width = self.reader.width
        self.height = self.reader.height
        if self.reader.fps:
            self.framerate = float(self.reader.fps)
        self.base_length = self.reader.frame_count - 1
        # consume the first frame (an IDR carries no vectors) so flow k
        # describes the step from frame k to k+1
        self.reader.next()

    def _rewind_reader(self, frame_index: int):
        self.reader.rewind()
        for _ in range(frame_index + 1):
            self.reader.next()

    def _read_item(self) -> FlowItem:
        vectors = self.reader.next()
        if vectors is None:
            raise StopIteration
        return FlowItem(FlowItem.FLOW,
                        rasterize(vectors, self.height, self.width))

    def _close_reader(self):
        if self.reader is not None:
            self.reader.close()
            self.reader = None


def rasterize(vectors: np.ndarray, height: int, width: int) -> np.ndarray:
    """One frame's records (an array over ``av_native.MV_DTYPE``) as a
    dense field, as transflow_tpu/flow/sources/mv.py:96-105 makes it: the
    block centred on (src_x, src_y) takes ``-motion / motion_scale``, in
    the records' order (the last write wins where blocks overlap). The
    loop reads the fields as Python ints, which gives the same slices and
    the same float64 quotients as the JAX source's numpy scalars, for a
    fraction of their cost a record."""
    flow = np.zeros((height, width, 2), dtype=np.float32)
    if (np.asarray(vectors["source"]) != -1).any():
        raise AssertionError("Encode with bf=0 and refs=1")
    columns = [np.asarray(vectors[name]).tolist() for name in
               ("src_x", "src_y", "w", "h", "motion_x", "motion_y",
                "motion_scale")]
    for sx, sy, w, h, mx, my, scale in zip(*columns):
        flow[sy - h // 2:sy + h // 2, sx - w // 2:sx + w // 2] = (
            -mx / scale, -my / scale)
    return flow
