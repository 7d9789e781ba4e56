"""Zip/numpy archive outputs: the .flow.zip writer and the checkpoint
container.

Counterpart of transflow_tpu/output/archive.py, the same members and
compression rule, so an archive or a checkpoint written by either package
reads in the other (tests/test_torch_io.py, tests/test_torch_pipeline.py).
"""
import io
import json
import zipfile
import zlib

import numpy as np

from ..utils import find_unique_path


class ZipOutput:
    """Deflated zip with a meta.json and named array members."""

    def __init__(self, path: str, replace: bool = False):
        self.path = path if replace else find_unique_path(path)
        self.zipfile = zipfile.ZipFile(self.path, "w",
                                       zipfile.ZIP_DEFLATED)

    def write_meta(self, meta: dict):
        self.zipfile.writestr("meta.json", json.dumps(meta))

    def write_array(self, name: str, array: np.ndarray):
        """Adaptive compression, as in the JAX package: dense float
        mantissas barely deflate, so a float member whose first 64 KiB
        do not deflate below half at level 1 is STORED (and read back
        zero-copy by ``flow/sources/archive.py``); other float members,
        such as all-zero flows, and every integer member (the
        ``--export-rounded-flow`` exports) are DEFLATED. Both are
        standard zip members."""
        array = np.asarray(array)
        buffer = io.BytesIO()
        np.save(buffer, array)
        payload = buffer.getvalue()
        compress = zipfile.ZIP_DEFLATED
        if array.dtype.kind == "f":
            probe = payload[:65536]
            if len(zlib.compress(probe, 1)) >= len(probe) // 2:
                compress = zipfile.ZIP_STORED
        self.zipfile.writestr(name, payload, compress_type=compress)

    def write_arrays(self, name: str, arrays: dict):
        """Store a dict of arrays as one .npz member."""
        buffer = io.BytesIO()
        np.savez(buffer, **{k: np.asarray(v) for k, v in arrays.items()})
        self.zipfile.writestr(name, buffer.getvalue())

    def close(self):
        self.zipfile.close()


class NumpyArchiveOutput:
    """The .flow.zip writer: meta.json + one %09d.npy per frame."""

    def __init__(self, path: str, meta: dict, replace: bool = False):
        self.zip_output = ZipOutput(path, replace)
        self.zip_output.write_meta(meta)
        self.counter = 0

    @property
    def path(self):
        return self.zip_output.path

    def write_array(self, array: np.ndarray):
        self.zip_output.write_array(f"{self.counter:09d}.npy", array)
        self.counter += 1

    def close(self):
        self.zip_output.close()
