"""The port's space mesh against the JAX package's mesh helpers.

``SpaceMesh`` holds one torch device per shard and may repeat a device, so
these run four real shards on the CPU. ``exchange_rows`` is the port's
counterpart of the two neighbour ``ppermute``s of the sharded entries.
"""
import numpy as np
import pytest
import torch

from transflow_tpu.parallel import mesh as jmesh
from transflow_tpu.parallel import multihost as jmultihost
from transflow_tpu_torch.parallel import (SpaceMesh, exchange_rows,
                                          global_mesh_grid, make_space_mesh,
                                          mesh_device, parse_mesh_spec)


@pytest.mark.parametrize("spec", ["8", "2x4", " 4 ", "1X2", "3x1", "x4",
                                  "two", "2x"])
def test_parse_mesh_spec_matches_jax(spec):
    try:
        want = jmesh.parse_mesh_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            parse_mesh_spec(spec)
        return
    assert parse_mesh_spec(spec) == want


@pytest.mark.parametrize("args", [(8, 4, None), (8, 4, 2), (16, 8, 4),
                                  (6, 2, 1), (8, 4, 3), (10, 4, 4),
                                  (4, 8, 8)], ids=str)
def test_global_mesh_grid_matches_jax(args):
    try:
        want = jmultihost.global_mesh_grid(*args)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            global_mesh_grid(*args)
        # the same condition fails first
        assert str(got.value).split(" (")[0] == str(err).split(" (")[0]
        return
    assert global_mesh_grid(*args) == want


def test_make_space_mesh_repeats_a_device():
    mesh = make_space_mesh(4, devices=["cpu"] * 4)
    assert isinstance(mesh, SpaceMesh)
    assert mesh.shape == {"space": 4}
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert make_space_mesh(2, devices=["cpu"] * 3).shape["space"] == 2
    with pytest.raises(ValueError, match="only 3 are visible"):
        make_space_mesh(4, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="at least one"):
        SpaceMesh([])


def test_make_space_mesh_defaults_to_cuda_devices():
    """Without a device list the mesh takes CUDA devices only: on a
    machine with fewer cards it raises instead of using the CPU."""
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"only {n} are visible"):
        make_space_mesh(n + 1)


def test_split_and_join():
    mesh = SpaceMesh(["cpu"] * 4)
    x = torch.arange(8 * 3 * 2).reshape(8, 3, 2)
    bands = mesh.split(x)
    assert [tuple(b.shape) for b in bands] == [(2, 3, 2)] * 4
    assert torch.equal(bands[2], x[4:6])
    assert torch.equal(mesh.join(bands, "cpu"), x)
    with pytest.raises(ValueError, match="does not shard"):
        mesh.split(torch.zeros(6, 3))


@pytest.mark.parametrize("rows", [1, 2, 3])
def test_exchange_rows(rows):
    """Shard i gets shard i-1's last rows on top and shard i+1's first
    rows below; the frame's edge shards get zeros."""
    mesh = SpaceMesh(["cpu"] * 4)
    x = torch.arange(1, 12 * 5 + 1, dtype=torch.float32).reshape(12, 5)
    bands = mesh.split(x)
    halos = exchange_rows(bands, rows, mesh)
    assert len(halos) == 4
    for i, (top, bottom) in enumerate(halos):
        assert top.shape == bottom.shape == (rows, 5)
        assert top.dtype == bottom.dtype == x.dtype
        want_top = x[3 * i - rows:3 * i] if i > 0 else torch.zeros(rows, 5)
        want_bottom = (x[3 * i + 3:3 * i + 3 + rows] if i < 3
                       else torch.zeros(rows, 5))
        assert torch.equal(top, want_top), i
        assert torch.equal(bottom, want_bottom), i


def test_exchange_rows_keeps_dtype_and_checks_rows():
    mesh = SpaceMesh(["cpu"] * 2)
    bands = mesh.split(torch.ones(8, 4, 3, dtype=torch.bfloat16))
    (top, bottom), (top1, bottom1) = exchange_rows(bands, 2, mesh)
    assert top.dtype == torch.bfloat16 and not top.any()
    assert bottom.all() and top1.all() and not bottom1.any()
    with pytest.raises(ValueError, match="rows"):
        exchange_rows(bands, 5, mesh)
    with pytest.raises(ValueError, match="rows"):
        exchange_rows(bands, 0, mesh)
    with pytest.raises(ValueError, match="bands"):
        exchange_rows(bands[:1], 1, mesh)


def test_mesh_device(monkeypatch):
    """Without a mesh or a device, the current CUDA device; with no card
    that raises (never the CPU)."""
    mesh = SpaceMesh(["cpu"] * 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mesh_device(None)
    assert mesh_device(None, "cpu") == torch.device("cpu")
    assert mesh_device(mesh) == torch.device("cpu")
    assert mesh_device(mesh, "cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="disagrees"):
        mesh_device(mesh, "meta")


def test_axis_sizes_read_as_in_jax():
    """Code written against a JAX mesh (``mesh.shape["space"]``) reads the
    port's mesh the same way."""
    jax_mesh = jmesh.make_space_mesh(4)
    mesh = make_space_mesh(4, devices=["cpu"] * 4)
    assert dict(jax_mesh.shape) == mesh.shape
    assert np.prod(list(mesh.shape.values())) == len(mesh.devices)
