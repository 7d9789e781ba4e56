"""The space mesh of the port: H split over a list of devices.

Counterpart of transflow_tpu/parallel/mesh.py for its one-axis ``space``
layout. The JAX package's mesh is a single-controller layout: one process
drives every device, ``shard_map`` splits exactly two ops by hand (the
sharded correlation and the sharded movement gather) and GSPMD places the
rest. The port keeps that form in one process: a ``SpaceMesh`` is a list
of torch devices, one per shard, and the two hand-sharded ops split their
operands over it, exchange boundary rows between neighbours (the two
``ppermute``s of the JAX entries) and join the result. Every other op runs
whole on ``mesh.devices[0]``.

Devices may repeat: ``SpaceMesh(["cuda:0"] * 4)`` runs four real shards,
with a real halo exchange, on one card, and ``SpaceMesh(["cpu"] * 4)``
does the same in the tests. A copy between two cards goes through
``Tensor.to``, which orders it on both devices' current streams, so a
shard's kernel never reads a halo before it has arrived.
"""
from typing import Sequence

import torch

from .._device import resolve_device


def _device(spec) -> torch.device:
    device = torch.device(spec)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class SpaceMesh:
    """One ``space`` axis over ``devices`` (shard i holds rows
    ``[i*H/n, (i+1)*H/n)``). ``shape`` reads as a JAX mesh's."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(_device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = {"space": len(self.devices)}

    def __repr__(self) -> str:
        return f"SpaceMesh({[str(d) for d in self.devices]})"

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x`` cut into n bands along H, band i on device i (a view where
        it is there already)."""
        n = len(self.devices)
        if x.shape[0] % n:
            raise ValueError(f"H={x.shape[0]} does not shard over {n} "
                             "devices")
        return [band.to(dev) for band, dev in
                zip(x.split(x.shape[0] // n), self.devices)]

    def join(self, bands: Sequence[torch.Tensor],
             device) -> torch.Tensor:
        """The bands, in order along H, as one tensor on ``device``."""
        return torch.cat([band.to(device) for band in bands])


def mesh_device(mesh: SpaceMesh | None, device=None) -> torch.device:
    """Where a run puts what it does not shard: ``mesh.devices[0]`` under a
    mesh (a ``device`` that disagrees raises), else ``device``, the
    current CUDA device by default (``_device.default_device``, which
    raises without a card)."""
    if mesh is None:
        return resolve_device(device)
    first = mesh.devices[0]
    if device is not None and _device(device) != first:
        raise ValueError(f"device {device} disagrees with the mesh, whose "
                         f"unsharded work runs on {first}")
    return first


def parse_mesh_spec(spec: str) -> tuple[int, int]:
    """'8' -> (1, 8); '2x4' -> (2, 4) as (stream, space)."""
    spec = spec.strip().lower()
    if "x" in spec:
        stream_str, space_str = spec.split("x", 1)
        return int(stream_str), int(space_str)
    return 1, int(spec)


def make_space_mesh(n_space: int, devices: Sequence | None = None
                    ) -> SpaceMesh:
    """A ``space`` mesh of ``n_space`` shards: the first ``n_space`` CUDA
    devices, or the first ``n_space`` of ``devices`` (which may repeat a
    device)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_space > len(devices):
        raise ValueError(
            f"mesh wants {n_space} devices but only {len(devices)} are "
            "visible")
    return SpaceMesh(devices[:n_space])


def exchange_rows(bands: Sequence[torch.Tensor], rows: int,
                  mesh: SpaceMesh) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """The halo exchange: shard i receives the last ``rows`` rows of shard
    i-1 (``top``) and the first ``rows`` rows of shard i+1 (``bottom``),
    on its own device. The frame's edge shards receive zeros, the frame's
    zero padding (pallas_correlation.py's two ``ppermute``s)."""
    n = len(bands)
    if n != len(mesh.devices):
        raise ValueError(f"{n} bands for a mesh of {len(mesh.devices)}")
    if not 1 <= rows <= min(b.shape[0] for b in bands):
        raise ValueError(f"rows={rows} needs 1 <= rows <= the shard height")
    def zeros(band):
        return band.new_zeros((rows,) + band.shape[1:])

    out = []
    for i, (band, dev) in enumerate(zip(bands, mesh.devices)):
        top = bands[i - 1][-rows:].to(dev) if i > 0 else zeros(band)
        bottom = bands[i + 1][:rows].to(dev) if i < n - 1 else zeros(band)
        out.append((top, bottom))
    return out
