"""Multi-host scale-out over ``torch.distributed``.

Counterpart of transflow_tpu/parallel/multihost.py. The ``space`` axis
(H sharding, halo exchanges) never crosses a host, so the global mesh is
host-major: hosts multiply the ``stream`` axis, and streams share
nothing. What crosses processes is the mesh's device lists, input frames
and results, never a halo: host objects and CPU tensors, so the process
group is gloo's. NCCL would also refuse what one card does here: two
ranks on one device.

``initialize`` brings the group up (``jax.distributed.initialize``);
``make_global_mesh`` gathers every process's devices into a ``StreamMesh``
whose rows each belong to one process. ``sharded_scan`` and
``shard_model_inputs`` then run and place only this process's streams
(``parallel/mesh.py``), as a JAX global array's ``addressable_shards``.
"""
from datetime import timedelta
from typing import Sequence

import torch
import torch.distributed as dist

from .mesh import RemoteRow, SpaceMesh, StreamMesh, _device


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout: float | None = None) -> None:
    """Join the gloo process group: at ``tcp://coordinator_address``
    (``host:port``, the rank-0 process listening) as rank ``process_id``
    of ``num_processes``, or, with all three None, from the environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as
    ``torchrun`` sets them). A no-op where a group exists. ``timeout``
    (seconds) bounds the rendezvous and every collective, so a process
    whose peer died fails instead of waiting."""
    if dist.is_initialized():
        return
    kwargs = {} if timeout is None else {
        "timeout": timedelta(seconds=timeout)}
    given = (coordinator_address, num_processes, process_id)
    if given == (None, None, None):
        dist.init_process_group("gloo", init_method="env://", **kwargs)
    elif None in given:
        raise ValueError("give coordinator_address, num_processes and "
                         "process_id together, or none of them (env://)")
    else:
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id, **kwargs)


def global_mesh_grid(n_devices: int, per_host: int,
                     space_axis: int | None = None) -> tuple[int, int]:
    """(stream, space) grid shape for ``n_devices`` across hosts of
    ``per_host`` devices each: ``space`` must divide the per-host device
    count, so halo exchanges stay inside a host; the rest, the host
    dimension included, multiplies into ``stream``."""
    if space_axis is None:
        space_axis = per_host
    if per_host % space_axis:
        raise ValueError(
            f"space axis {space_axis} must divide the per-host device "
            f"count {per_host} (halo exchange must stay inside a host)")
    if n_devices % space_axis:
        raise ValueError(
            f"space axis {space_axis} must divide the global device "
            f"count {n_devices}")
    return n_devices // space_axis, space_axis


def make_global_mesh(space_axis: int | None = None,
                     devices: Sequence | None = None,
                     per_host: int | None = None) -> StreamMesh:
    """The ``(stream, space)`` mesh over every device of every process.

    Under a process group each process gives its local ``devices`` (every
    CUDA device by default; a device may repeat), gathered in rank order
    (host-major), and a row belongs to the process that gave its devices.
    With no group ``devices`` is the whole list, one host unless
    ``per_host`` cuts it: device k then belongs to process k // per_host,
    and this process is 0. ``per_host`` defaults to the local count;
    ``space_axis`` to ``per_host``. This process's rows are
    ``SpaceMesh``es, the others' ``RemoteRow``s; a row that would span two
    processes raises."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    local = [str(_device(d)) for d in devices]
    if not local:
        raise ValueError("make_global_mesh needs at least one local device "
                         "(no CUDA device here: pass devices)")
    if per_host is None:
        per_host = len(local)
    if dist.is_initialized():
        gathered: list = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, local)
        process = dist.get_rank()
        names = [d for host in gathered for d in host]
        owners = [rank for rank, host in enumerate(gathered) for _ in host]
    else:
        process = 0
        names = local
        owners = [k // per_host for k in range(len(names))]
    n_streams, n_space = global_mesh_grid(len(names), per_host, space_axis)
    rows, processes = [], []
    for s in range(n_streams):
        cut = slice(s * n_space, (s + 1) * n_space)
        if len(set(owners[cut])) != 1:
            raise ValueError(
                f"space row {s} spans processes {sorted(set(owners[cut]))}: "
                "it must stay inside a host")
        owner = owners[cut.start]
        rows.append(SpaceMesh(names[cut]) if owner == process
                    else RemoteRow(tuple(names[cut])))
        processes.append(owner)
    return StreamMesh(rows, processes, process)
