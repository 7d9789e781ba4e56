"""Published-weights check of the port's LiteFlowNet, in one command.

Counterpart of tools/verify_weights.py over the port. Given the
reference's checkpoint (``network-default.pytorch`` from
sniklaus/pytorch-liteflownet, which the repository does not hold):

    python -m transflow_tpu_torch.tools.verify_weights \\
        /path/to/network-default.pytorch [--device cpu]

it

  1. computes the file's SHA-256 and compares it with the digest pinned
     in docs/WEIGHTS.md ("unpinned" while none is);
  2. reads the checkpoint with ``torch.load(weights_only=True)`` and
     checks its tensors (names, shapes, dtypes) against the port's
     ``LiteFlowNet`` module's own, in the checkpoint's layout;
  3. where they match, loads it through the port's loader
     (``flow/estimators/liteflownet.py::load_torch_weights``) and runs one
     forward pass on two bundled deterministic frames, printing a digest
     of the flow (mean |u|, mean |v|, SHA-256 of the field rounded to
     1e-3) to compare with the JAX tool's on the same file.

It prints one JSON object and exits 0 only when every check passed. The
forward pass runs on the current CUDA device by default. The JAX tool's
``--reference`` (the reference's own network) is not ported.
"""
import argparse
import hashlib
import json
import re
import sys

import numpy as np

from .._device import PACKAGE_DIR, resolve_device

DOCS = PACKAGE_DIR.parent / "docs" / "WEIGHTS.md"
FRAME_H, FRAME_W = 256, 448  # the bundled frames' size


def bundled_frames(height=None, width=None):
    """Two deterministic moving-texture frames, (H, W, 3) uint8, the second
    shifted by dy=-3, dx=+2 (tools/verify_weights.py::bundled_frames)."""
    import scipy.ndimage
    height = FRAME_H if height is None else height
    width = FRAME_W if width is None else width
    rng = np.random.default_rng(7)
    base = scipy.ndimage.gaussian_filter(
        rng.integers(0, 256, (height + 32, width + 32)).astype(np.float32), 2)
    base = (255 * (base - base.min()) / np.ptp(base)).astype(np.uint8)
    f0 = base[16:16 + height, 16:16 + width]
    f1 = base[13:13 + height, 18:18 + width]
    return (np.repeat(f0[..., None], 3, axis=2),
            np.repeat(f1[..., None], 3, axis=2))


def sha256_of(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as file:
        for block in iter(lambda: file.read(1 << 20), b""):
            digest.update(block)
    return digest.hexdigest()


def pinned_sha() -> str | None:
    """The digest docs/WEIGHTS.md pins, None while it pins none."""
    try:
        text = DOCS.read_text()
    except OSError:
        return None
    match = re.search(r"sha256:\s*`([0-9a-f]{64})`", text)
    return match.group(1) if match else None


def flow_digest(flow: np.ndarray) -> dict:
    rounded = np.round(np.asarray(flow, np.float64), 3)
    return {
        "shape": list(flow.shape),
        "mean_abs_u": round(float(np.mean(np.abs(rounded[..., 0]))), 4),
        "mean_abs_v": round(float(np.mean(np.abs(rounded[..., 1]))), 4),
        "sha256_rounded_mm": hashlib.sha256(
            rounded.astype("<f8").tobytes()).hexdigest(),
    }


def tree_problems(checkpoint: dict) -> tuple[int, list[str]]:
    """(the count of the network's tensors, what in ``checkpoint`` differs
    from them): each missing, unexpected, misshapen or mistyped tensor, by
    its checkpoint name."""
    from ..flow.estimators.liteflownet import LiteFlowNet, torch_state_keys
    own = LiteFlowNet().state_dict()
    want = {src: own[key] for key, src in torch_state_keys().items()}
    got = {key.replace("module", "net"): value
           for key, value in checkpoint.items()}
    problems = []
    for name, spec in want.items():
        if name not in got:
            problems.append(f"missing: {name}")
            continue
        leaf = got[name]
        if tuple(leaf.shape) != tuple(spec.shape):
            problems.append(f"shape {name}: {tuple(leaf.shape)} != "
                            f"{tuple(spec.shape)}")
        if leaf.dtype != spec.dtype:
            problems.append(f"dtype {name}: {leaf.dtype} != {spec.dtype}")
    problems += [f"unexpected: {name}" for name in got if name not in want]
    return len(want), problems


def verify(path: str, device=None) -> dict:
    """The checks above on the checkpoint at ``path``; the forward pass on
    ``device`` (the current CUDA device by default)."""
    import torch

    from ..flow.estimators.liteflownet import (LiteFlowNet, liteflownet,
                                               load_torch_weights)
    out: dict = {"file": path, "sha256": sha256_of(path)}
    pin = pinned_sha()
    out["sha256_pinned"] = pin
    out["sha256_match"] = (pin == out["sha256"]) if pin else "unpinned"
    leaves, problems = tree_problems(
        torch.load(path, map_location="cpu", weights_only=True))
    out["tree_leaves"] = leaves
    out["tree_problems"] = problems
    if not problems:
        device = resolve_device(device)
        net = LiteFlowNet()
        net.load_state_dict(load_torch_weights(path))
        net = net.to(device).eval().requires_grad_(False)
        f0, f1 = bundled_frames()
        flow = liteflownet(f0, f1, net=net)
        out["device"] = str(device)
        out["flow_golden"] = flow_digest(flow.cpu().numpy())
    # a digest that differs from the pinned one fails; an unpinned one
    # does not
    out["ok"] = not problems and out["sha256_match"] is not False
    return out


def main(argv=None, device=None) -> int:
    """Run the check and print its JSON; returns the exit code."""
    parser = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("path", help="network-default.pytorch")
    parser.add_argument("--device", default=device,
                        help="where the forward pass runs: cpu, or a CUDA "
                             "device (default: the current one)")
    args = parser.parse_args(argv)
    result = verify(args.path, args.device)
    print(json.dumps(result, indent=2))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
