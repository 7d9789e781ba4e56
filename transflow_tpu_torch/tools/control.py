"""Alteration editor: read a checkpoint's mapping and paint the source.

Counterpart of extra/control.py over the port: ``ControlSession`` reads a
``.ckpt.zip`` of either package (``layer{n}.pos_i`` and ``pos_j``, which
both engines write), tells which source pixel each output pixel samples,
paints colors onto the source so the advected output is controlled, and
exports the painting as an alteration PNG (``--alteration``). The window
is cv2's and needs a display; ``--silent`` (or no ``DISPLAY``) exports
the (empty) alteration.

Usage:
  python -m transflow_tpu_torch.tools.control out/%04d_00023.ckpt.zip \\
      --silent -o alteration.png
"""
import argparse
import io
import json
import os
import zipfile

import numpy as np

from ..utils.colors import parse_color
from ..utils.misc import require


class ControlSession:
    """Headless checkpoint-mapping editor."""

    def __init__(self, ckpt_path: str, layer: int = 0):
        with zipfile.ZipFile(ckpt_path) as archive:
            with archive.open("meta.json") as file:
                self.meta = json.loads(file.read().decode())
            with archive.open("state.npz") as file:
                arrays = np.load(io.BytesIO(file.read()))
                self.arrays = {k: arrays[k] for k in arrays.files}
        prefix = f"layer{layer}."
        if prefix + "pos_i" not in self.arrays:
            raise ValueError(
                f"Checkpoint has no coordinate mapping for layer {layer} "
                f"(static/introduction layers have no reference mapping)")
        self.pos_i = self.arrays[prefix + "pos_i"]
        self.pos_j = self.arrays[prefix + "pos_j"]
        self.height, self.width = self.pos_i.shape
        # alteration canvas over the SOURCE (pixmap) space
        self.alteration = np.zeros((self.height, self.width, 4),
                                   dtype=np.uint8)

    def source_of(self, i: int, j: int) -> tuple[int, int]:
        """Which source pixel the output pixel (i, j) samples."""
        return (int(np.clip(self.pos_i[i, j], 0, self.height - 1)),
                int(np.clip(self.pos_j[i, j], 0, self.width - 1)))

    def outputs_of(self, si: int, sj: int) -> np.ndarray:
        """Boolean mask of output pixels sampling source pixel (si, sj)."""
        return (self.pos_i == si) & (self.pos_j == sj)

    def paint(self, i: int, j: int, color, radius: int = 0):
        """Paint the source pixel(s) backing output (i, j)."""
        if isinstance(color, str):
            color = parse_color(color)
        for di in range(-radius, radius + 1):
            for dj in range(-radius, radius + 1):
                ii = int(np.clip(i + di, 0, self.height - 1))
                jj = int(np.clip(j + dj, 0, self.width - 1))
                si, sj = self.source_of(ii, jj)
                self.alteration[si, sj] = (*color, 255)

    def erase(self, i: int, j: int, radius: int = 0):
        for di in range(-radius, radius + 1):
            for dj in range(-radius, radius + 1):
                ii = int(np.clip(i + di, 0, self.height - 1))
                jj = int(np.clip(j + dj, 0, self.width - 1))
                si, sj = self.source_of(ii, jj)
                self.alteration[si, sj] = 0

    def reset(self):
        self.alteration[:] = 0

    def preview(self) -> np.ndarray:
        """What the painted output looks like: gather alteration through the
        mapping (painted where opaque, mapping-colored elsewhere)."""
        gathered = self.alteration[np.clip(self.pos_i, 0, self.height - 1),
                                   np.clip(self.pos_j, 0, self.width - 1)]
        base = np.zeros((self.height, self.width, 3), np.uint8)
        base[..., 0] = (255 * self.pos_j / max(1, self.width - 1)).astype(
            np.uint8)
        base[..., 1] = (255 * self.pos_i / max(1, self.height - 1)).astype(
            np.uint8)
        mask = gathered[..., 3:4] > 0
        return np.where(mask, gathered[..., :3], base)

    def export(self, path: str):
        """Write the alteration as an RGBA PNG (through PIL)."""
        from ..utils.imageio import imwrite
        imwrite(path, self.alteration)
        return path


def run_window(session: ControlSession, export_path: str):
    """The editor's window until q or ESC: left button paints, right
    erases; c cycles the color, r resets, s exports to ``export_path``."""
    cv2 = require("cv2", "the alteration editor's window")
    state = {"color": (255, 0, 0), "down": None}
    window = "transflow-tpu control"

    def on_mouse(event, x, y, flags, param):
        if event == cv2.EVENT_LBUTTONDOWN or (
                flags & cv2.EVENT_FLAG_LBUTTON):
            session.paint(y, x, state["color"], radius=2)
        elif event == cv2.EVENT_RBUTTONDOWN or (
                flags & cv2.EVENT_FLAG_RBUTTON):
            session.erase(y, x, radius=2)

    cv2.namedWindow(window, cv2.WINDOW_AUTOSIZE)
    cv2.setMouseCallback(window, on_mouse)
    palette = [(255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0),
               (255, 0, 255), (0, 255, 255), (255, 255, 255), (0, 0, 0)]
    color_idx = 0
    while True:
        frame = session.preview()
        cv2.imshow(window, cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        key = cv2.waitKey(30) & 0xFF
        if key in (27, ord("q")):
            break
        if key == ord("c"):
            color_idx = (color_idx + 1) % len(palette)
            state["color"] = palette[color_idx]
        if key == ord("r"):
            session.reset()
        if key == ord("s"):
            print("exported", session.export(export_path))
    cv2.destroyWindow(window)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("checkpoint", help="path to a .ckpt.zip")
    parser.add_argument("-l", "--layer", type=int, default=0)
    parser.add_argument("-o", "--output", default="alteration.png")
    parser.add_argument("--silent", action="store_true",
                        help="headless: just validate the checkpoint and "
                        "export an (empty) alteration")
    args = parser.parse_args(argv)
    session = ControlSession(args.checkpoint, args.layer)
    if args.silent or os.environ.get("DISPLAY") is None:
        session.export(args.output)
        print(f"mapping {session.width}x{session.height}; exported "
              f"{args.output}")
        return
    run_window(session, args.output)


if __name__ == "__main__":
    main()
