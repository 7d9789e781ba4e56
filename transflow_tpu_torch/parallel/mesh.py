"""The meshes of the port: H split over a list of devices (``space``),
and independent streams over rows of such lists (``stream``).

Counterpart of transflow_tpu/parallel/mesh.py. The JAX package's mesh is a
single-controller layout: one process drives every device, ``shard_map``
splits exactly two ops by hand (the sharded correlation and the sharded
movement gather) and GSPMD places the rest. The port keeps that form in
one process: a ``SpaceMesh`` is a list of torch devices, one per shard,
and a hand-sharded op splits its operands over it, exchanges boundary
rows between neighbours (the two ``ppermute``s of the JAX entries) and
joins the result. The correlation runs so on the main path; the
compositor's movement reads through the bounded gather whole on
``mesh.devices[0]``, as every other op runs, which equals the sharded
one (``ops/halo_gather.py::sharded_bounded_gather``, kept and tested).

Devices may repeat: ``SpaceMesh(["cuda:0"] * 4)`` runs four real shards,
with a real halo exchange, on one card, and ``SpaceMesh(["cpu"] * 4)``
does the same in the tests. A copy between two cards goes through
``Tensor.to``, which orders it on both devices' current streams, so a
shard's kernel never reads a halo before it has arrived.

The ``(stream, space)`` layout (``make_mesh``) is a ``StreamMesh``: S rows,
each a ``SpaceMesh`` of P devices. Streams share nothing, so where JAX
vmaps ``model.scan`` over a stream axis under one jit (``sharded_scan``),
the port runs ``model.scan`` once per stream on its row: a stream's work
is queued on its row's devices, and rows on distinct cards overlap, as
the launches do not wait for the host.

Across processes (``multihost.make_global_mesh``) a ``StreamMesh`` also
knows the process that owns each row: this process's rows are
``SpaceMesh``es, another's are ``RemoteRow``s, names that are never made
into local torch devices. ``shard_model_inputs`` and ``sharded_scan``
then place and run only the local rows' streams and return ``None`` for
the others, as a JAX global array's ``addressable_shards``.
"""
from typing import Callable, NamedTuple, Sequence

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


class RemoteRow(NamedTuple):
    """A row of a global mesh that another process owns: its devices as
    that process named them (``"cuda:0"``), kept as names."""
    devices: tuple[str, ...]


class StreamMesh:
    """The ``(stream, space)`` layout: ``rows[s]`` is the ``SpaceMesh`` of
    stream row s, or a ``RemoteRow`` where another process owns it.
    ``processes[s]`` is the process that owns row s and ``process`` this
    one (by default every row is this process's). ``shape`` reads as a
    JAX mesh's."""

    def __init__(self, rows: Sequence, processes: Sequence[int] | None = None,
                 process: int = 0):
        self.rows = tuple(rows)
        if not self.rows or len({len(r.devices) for r in self.rows}) != 1:
            raise ValueError("a stream mesh needs rows of one length")
        self.process = process
        self.processes = (tuple(processes) if processes is not None
                          else (process,) * len(self.rows))
        if len(self.processes) != len(self.rows) or any(
                isinstance(row, SpaceMesh) != (owner == process)
                for row, owner in zip(self.rows, self.processes)):
            raise ValueError("each of this process's rows is a SpaceMesh "
                             "and each other process's a RemoteRow")
        self.shape = {"stream": len(self.rows),
                      "space": len(self.rows[0].devices)}
        self.devices = tuple(d for row in self.rows for d in row.devices)

    def __repr__(self) -> str:
        rows = [[str(d) for d in r.devices] for r in self.rows]
        if set(self.processes) == {self.process}:
            return f"StreamMesh({rows})"
        return (f"StreamMesh({rows}, processes={list(self.processes)}, "
                f"process={self.process})")

    def row_index(self, stream: int, n_streams: int) -> int:
        """The row that holds ``stream`` of ``n_streams``: contiguous
        blocks of ``n_streams / S`` streams a row, as JAX shards a leading
        dim over the ``stream`` axis."""
        per_row, rest = divmod(n_streams, self.shape["stream"])
        if rest:
            raise ValueError(
                f"stream count {n_streams} must be a multiple of the mesh's "
                f"stream axis {self.shape['stream']}")
        return stream // per_row

    def row_of(self, stream: int, n_streams: int):
        """The row (``SpaceMesh`` or ``RemoteRow``) that holds ``stream``
        of ``n_streams``."""
        return self.rows[self.row_index(stream, n_streams)]

    def is_local(self, stream: int, n_streams: int) -> bool:
        """Whether this process runs ``stream`` of ``n_streams``."""
        return self.processes[self.row_index(stream, n_streams)] \
            == self.process


def make_mesh(n_devices: int | None = None, stream_axis: int | None = None,
              devices: Sequence | None = None) -> StreamMesh:
    """A ``(stream, space)`` mesh over the first ``n_devices`` of
    ``devices`` (every CUDA device by default; a device may repeat).
    ``stream_axis`` defaults to 2 where ``n_devices`` is even and > 1,
    else 1; the remaining factor shards space (mesh.py:52-66)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is None:
        n_devices = len(devices)
    devices = devices[:n_devices]
    if stream_axis is None:
        stream_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    space_axis = n_devices // stream_axis
    if not devices or stream_axis * space_axis != len(devices):
        raise ValueError(f"{len(devices)} devices do not form a "
                         f"{stream_axis} x {space_axis} mesh")
    return StreamMesh([
        SpaceMesh(devices[s * space_axis:(s + 1) * space_axis])
        for s in range(stream_axis)])


def _to(tree, device):
    """``tree`` (tensors in dicts, tuples and lists; other leaves kept)
    with every tensor on ``device``; a tensor there already is kept."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


def _home(row: SpaceMesh) -> torch.device:
    """Where a row's model keeps what it does not shard."""
    return row.devices[0]


def shard_model_inputs(mesh: StreamMesh, state, grays, pixmaps, keys):
    """The scan's inputs placed on their rows (mesh.py:127): stream n's
    state (a sequence of N per-stream states), frames (``grays[n]``) and
    key (``keys[n]``) on its row, and the one pixmap set replicated, one
    copy per row device (JAX's ``pixmap_spec``: the render gather's reach
    is unbounded), as N per-stream entries that ``sharded_scan(...,
    per_stream_pixmaps=True)`` takes. A row's model splits H over the
    row's devices inside its sharded ops, so each slice goes whole to the
    row's first device. Returns (state, grays, pixmaps, keys), each a
    tuple of N, with ``None`` for a stream another process owns (its
    inputs are not read)."""
    n = len(state)
    homes = [_home(mesh.row_of(i, n)) if mesh.is_local(i, n) else None
             for i in range(n)]
    copies = {h: _to(pixmaps, h) for h in homes if h is not None}
    return (tuple(None if h is None else _to(st, h)
                  for st, h in zip(state, homes)),
            tuple(None if h is None else _to(torch.as_tensor(g), h)
                  for g, h in zip(grays, homes)),
            tuple(copies.get(h) for h in homes),
            tuple(None if h is None else k for k, h in zip(keys, homes)))


def sharded_scan(model, mesh: StreamMesh, per_stream_pixmaps: bool = False
                 ) -> Callable:
    """``model.scan`` over independent streams (mesh.py:144-206).

    Returns ``fn(state, grays, pixmaps, t0, keys) -> (state, rgbs)``:
    ``state``, ``grays`` ((K, H, W) frames) and ``keys`` carry a leading
    stream dim of N, a multiple of the stream axis (a sequence, or a
    stacked array); stream n runs ``model.scan`` on its row
    (``StreamMesh.row_of``), the same as ``vmap(model.scan)``. The
    returned state and frames are tuples of N, each on its row. On a
    global mesh only this process's streams run: another process's
    stream gives ``None`` in both, and its inputs are not read (they may
    be ``None``).

    ``per_stream_pixmaps``: ``pixmaps`` is a sequence of N pixmap sets,
    and each stream advects its own (extra/batch_render.py); by default
    one set, copied to each row, serves every stream.

    The model is bound to its devices when built (``model.py``), so a
    row on other devices runs a replica built with the same arguments
    there (``FlowTransferModel.replica``); the row on the model's own
    devices runs the model itself. Replicas are built for local rows
    only."""
    space = mesh.shape["space"]
    replicas: dict = {}

    def row_model(row: SpaceMesh):
        if row.devices not in replicas:
            replicas[row.devices] = model.replica(
                mesh=row if space > 1 else None, device=_home(row))
        return replicas[row.devices]

    def run(state, grays, pixmaps, t0, keys):
        n = len(state)
        shared: dict = {}
        states, rgbs = [], []
        for i in range(n):
            if not mesh.is_local(i, n):
                states.append(None)
                rgbs.append(None)
                continue
            row = mesh.row_of(i, n)
            home = _home(row)
            if per_stream_pixmaps:
                pix = _to(pixmaps[i], home)
            else:
                if home not in shared:
                    shared[home] = _to(pixmaps, home)
                pix = shared[home]
            new_state, rgb = row_model(row).scan(
                _to(state[i], home), torch.as_tensor(grays[i]).to(home),
                pix, t0, keys[i])
            states.append(new_state)
            rgbs.append(rgb)
        return tuple(states), tuple(rgbs)

    return run
