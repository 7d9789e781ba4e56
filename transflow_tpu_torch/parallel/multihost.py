"""Multi-host layout arithmetic.

Counterpart of transflow_tpu/parallel/multihost.py. The ``space`` axis
(H sharding, halo exchanges) never crosses a host, so the global grid is
host-major: hosts multiply the ``stream`` axis. ``global_mesh_grid`` is
the pure arithmetic of that rule; bringing up several processes over
``torch.distributed`` (``initialize``, ``make_global_mesh``) waits for
ROADMAP Queue 1, item 12.
"""


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
