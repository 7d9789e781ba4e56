"""Batch renderer: N independent clips through the port's stream mesh.

Counterpart of extra/batch_render.py over the port: every input clip
advects its own pixmap, the streams run through ``sharded_scan`` over the
``stream`` axis of ``parallel.make_mesh`` (H split within each stream's
row where the space axis is > 1), one call per chunk, and each stream
writes its own output.

Usage:
  python -m transflow_tpu_torch.tools.batch_render out_dir \\
      a/%04d.pgm:pix_a.ppm b/%04d.pgm:pix_b.ppm \\
      [--chunk 8] [--method horn-schunck] [--reset random:0.05] \\
      [--halo 8] [--seed 0] [--output stream{stream:02d}.avi]

Inputs are videos (decoded through cv2, ``utils/imageio.py::
VideoSequence``) or image sequences (netpbm, or PIL's formats), each
with a pixmap image, resized to the frames by ``cv2.resize`` where its
size differs. Outputs go through ``VideoOutput.from_args``: by default
``stream%02d.avi`` per stream in MJPG, as the JAX tool writes them (the
encoder chain's cv2 rung opens MJPG for ``vcodec="mjpeg"``); ``--output``
names another file (``.avi`` in MJPG, any other container in H.264) or a
``%04d`` frame template. All inputs share one frame size; the run is as
long as the shortest; the stream count must be a multiple of the mesh's
stream axis.
"""
import argparse
import os

import numpy as np
import torch

DEFAULT_OUTPUT = "stream{stream:02d}.avi"


def output_vcodec(output: str) -> str:
    """The codec of an output file: MJPG for ``.avi`` (as the JAX tool
    writes it), H.264 for any other container."""
    return "mjpeg" if output.lower().endswith(".avi") else "h264"


def decode_all(path: str) -> tuple[np.ndarray, float]:
    """A sequence's frames as (N, H, W) uint8 gray, and its frame rate."""
    from ..utils.imageio import open_sequence
    sequence = open_sequence(path)
    frames = []
    while (frame := sequence.read(gray=True)) is not None:
        frames.append(frame)
    return np.stack(frames), sequence.framerate


def load_pixmap(path: str, h: int, w: int) -> np.ndarray:
    """An image as (h, w, 3) RGB uint8; one of another size is resized by
    ``cv2.resize`` (bilinear), as the JAX tool resizes it."""
    from ..utils.imageio import imread, to_rgb
    from ..utils.misc import require
    image = to_rgb(imread(path))
    if image.shape[:2] != (h, w):
        cv2 = require("cv2", f"resizing the pixmap {path!r} to {w}x{h}")
        image = cv2.resize(np.ascontiguousarray(image), (w, h))
    return image


def batch_render(pairs, out_dir: str, chunk: int = 8,
                 method: str = "horn-schunck", reset=("random", 0.05),
                 halo: int | None = None, seed: int = 0,
                 estimator_kwargs: dict | None = None,
                 output: str = DEFAULT_OUTPUT, mesh=None,
                 vcodec: str | None = None) -> list[str]:
    """Render [(frames_path, pixmap_path), ...] into ``out_dir``, stream s
    to ``output.format(stream=s)`` in ``vcodec`` (``output_vcodec(output)``
    by default); returns the output paths. ``mesh``: a ``StreamMesh``,
    ``make_mesh()`` over every CUDA device by default."""
    from .. import prng
    from ..config import LayerConfig
    from ..engine import mesh_safe_kwargs
    from ..flow import Direction
    from ..model import FlowTransferModel
    from ..output.video_output import VideoOutput
    from ..parallel.mesh import make_mesh, sharded_scan

    decoded = [decode_all(path) for path, _ in pairs]
    h, w = decoded[0][0].shape[1:]
    for frames, _ in decoded:
        if frames.shape[1:] != (h, w):
            raise ValueError("all flow inputs must share the same size")
    n_frames = min(frames.shape[0] for frames, _ in decoded)
    fps = decoded[0][1]
    pixmaps_np = [load_pixmap(path, h, w) for _, path in pairs]

    if mesh is None:
        mesh = make_mesh()
    n_streams = mesh.shape["stream"]
    if len(pairs) % n_streams:
        raise ValueError(
            f"stream count {len(pairs)} must be a multiple of the mesh's "
            f"stream axis {n_streams} (pad by repeating inputs)")

    mode, factor = reset
    layer_cfgs = [LayerConfig(0, reset_mode=mode, reset_random_factor=factor,
                              reset_linear_factor=factor,
                              reset_constant_step=factor)]
    row = mesh.rows[0]
    row_mesh = row if mesh.shape["space"] > 1 else None
    kwargs = estimator_kwargs if estimator_kwargs is not None else (
        dict(max_iters=8, delta=None) if method == "horn-schunck" else {})
    # mesh-safe estimator kwargs: the sharded correlation over the row,
    # the bounded warp off
    kwargs = mesh_safe_kwargs(kwargs, method, row_mesh)
    model = FlowTransferModel(
        h, w, layer_cfgs, {0: [(3, np.ones((h, w), bool))]},
        method=method, estimator_kwargs=kwargs,
        direction=Direction.BACKWARD,
        flow_filters=f"clip={halo}" if halo else None, halo=halo,
        mesh=row_mesh, device=row.devices[0])

    os.makedirs(out_dir, exist_ok=True)
    vcodec = vcodec or output_vcodec(output)
    outputs = [VideoOutput.from_args(
        os.path.join(out_dir, output.format(stream=idx)), w, h, fps,
        vcodec=vcodec, replace=True).open() for idx in range(len(pairs))]
    run = sharded_scan(model, mesh, per_stream_pixmaps=True)
    try:
        # mesh-wide groups of streams; one sharded_scan call per chunk
        for group0 in range(0, len(pairs), n_streams):
            # a group's stream k runs on row k
            group = range(group0, group0 + n_streams)
            state = [model.init_state(decoded[s][0][0]) for s in group]
            # each stream's own pixmap, placed on its row once
            pixmaps = [tuple(
                tuple(torch.as_tensor(pixmaps_np[s], device=r.devices[0])
                      for _ in layer.channel_counts)
                for layer in model.layer_params)
                for s, r in zip(group, mesh.rows)]
            keys = prng.split(prng.key(seed + group0), n_streams)
            t0 = 0.0
            for start in range(1, n_frames, chunk):
                stop = min(start + chunk, n_frames)
                grays = [decoded[s][0][start:stop] for s in group]
                chunk_keys = [prng.fold_in(k, start) for k in keys]
                state, rgbs = run(state, grays, pixmaps, t0, chunk_keys)
                for s, frames in zip(group, rgbs):
                    for frame in frames.cpu().numpy():
                        outputs[s].feed(frame)
                t0 += (stop - start) / fps
    finally:
        for out in outputs:
            out.close()
    return [out.output_path for out in outputs]


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("out_dir")
    parser.add_argument("pairs", nargs="+",
                        help="frames_sequence:pixmap_image pairs")
    parser.add_argument("--chunk", type=int, default=8)
    parser.add_argument("--method", default="horn-schunck")
    parser.add_argument("--reset", default="random:0.05")
    parser.add_argument("--halo", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--output", default=DEFAULT_OUTPUT,
                        help="each stream's output under out_dir, "
                             "{stream} its index: a video file (.avi in "
                             "MJPG, another container in H.264), or a "
                             "%%04d frame template (default %(default)s)")
    args = parser.parse_args(argv)
    pairs = [tuple(p.split(":", 1)) for p in args.pairs]
    mode, _, factor = args.reset.partition(":")
    outputs = batch_render(pairs, args.out_dir, chunk=args.chunk,
                           method=args.method,
                           reset=(mode, float(factor or 0.05)),
                           halo=args.halo, seed=args.seed,
                           output=args.output)
    for path in outputs:
        print(path)


if __name__ == "__main__":
    main()
