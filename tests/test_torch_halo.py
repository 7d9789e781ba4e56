"""The port's bounded and sharded movement gathers against the JAX
package's, and the moveref compositor under ``halo`` and a mesh.

The JAX side runs as tests/test_halo_gather.py runs it, on the virtual
CPU mesh of tests/conftest.py; the port over ``SpaceMesh(["cpu"] * n)``.
Both compositors draw the random reset from the same key.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from transflow_tpu.compositor import core as jcore
from transflow_tpu.config import LayerConfig as JaxLayerConfig
from transflow_tpu.ops import halo_gather as jhalo
from transflow_tpu.parallel.mesh import make_space_mesh as jax_space_mesh
from transflow_tpu_torch.compositor import core
from transflow_tpu_torch.config import LayerConfig
from transflow_tpu_torch.ops import halo_gather
from transflow_tpu_torch.parallel import SpaceMesh


def _indices(h, w, reach_i, reach_j, seed):
    """In-frame (src_i, src_j) int32 with row reach up to ``reach_i``."""
    rng = np.random.default_rng(seed)
    ii, jj = np.indices((h, w))
    src_i = np.clip(ii + rng.integers(-reach_i, reach_i + 1, (h, w)),
                    0, h - 1).astype(np.int32)
    src_j = np.clip(jj + rng.integers(-reach_j, reach_j + 1, (h, w)),
                    0, w - 1).astype(np.int32)
    return src_i, src_j


def _values(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.random(shape) > 0.5
    if dtype == "f32":
        return rng.standard_normal(shape).astype(np.float32)
    return rng.integers(0, 256, shape).astype(np.uint8)


GATHER_CASES = {"2d-f32": ((24, 32), "f32"), "3d-u8": ((24, 32, 6), "u8"),
                "2d-bool": ((24, 32), "bool")}


@pytest.mark.parametrize("reach", [3, 9], ids=["within", "beyond"])
@pytest.mark.parametrize("case", list(GATHER_CASES))
def test_bounded_row_gather_matches_jax(case, reach):
    shape, dtype = GATHER_CASES[case]
    halo = 3
    v = _values(shape, 0, dtype)
    src_i, src_j = _indices(shape[0], shape[1], reach, 7, 1)
    want = np.asarray(jhalo.bounded_row_gather(
        jnp.asarray(v), jnp.asarray(src_i), jnp.asarray(src_j), halo))
    got = halo_gather.bounded_row_gather(
        torch.from_numpy(v), torch.from_numpy(src_i),
        torch.from_numpy(src_j), halo)
    assert got.dtype == torch.from_numpy(v).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if reach <= halo:       # within the halo: the plain gather
        np.testing.assert_array_equal(got.numpy(), v[src_i, src_j])


@pytest.mark.parametrize("reach", [3, 9], ids=["within", "beyond"])
@pytest.mark.parametrize("shape", [(32, 32), (32, 32, 6)], ids=str)
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_bounded_gather_matches_jax(n, shape, reach):
    halo = 3
    v = _values(shape, 2, "u8")
    src_i, src_j = _indices(shape[0], shape[1], reach, 7, 3)
    jmesh = jax_space_mesh(n)
    with jmesh:
        want = np.asarray(jhalo.sharded_bounded_gather(
            jnp.asarray(v), jnp.asarray(src_i), jnp.asarray(src_j), halo,
            jmesh))
    got = halo_gather.sharded_bounded_gather(
        torch.from_numpy(v), torch.from_numpy(src_i),
        torch.from_numpy(src_j), halo, SpaceMesh(["cpu"] * n))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), halo_gather.bounded_row_gather(
            torch.from_numpy(v), torch.from_numpy(src_i),
            torch.from_numpy(src_j), halo).numpy())


@pytest.mark.parametrize("h,halo", [(10, 2), (8, 0), (8, 3)],
                         ids=["indivisible", "halo-0", "halo-past-shard"])
def test_sharded_bounded_gather_preconditions(h, halo):
    """H must split over the mesh and 1 <= halo <= H / n, as in JAX."""
    n = 4
    idx = np.zeros((h, 8), np.int32)
    jmesh = jax_space_mesh(n)
    with pytest.raises(ValueError):
        with jmesh:
            jhalo.sharded_bounded_gather(jnp.zeros((h, 8), jnp.uint8),
                                         jnp.asarray(idx), jnp.asarray(idx),
                                         halo, jmesh)
    with pytest.raises(ValueError):
        halo_gather.sharded_bounded_gather(
            torch.zeros((h, 8), dtype=torch.uint8), torch.from_numpy(idx),
            torch.from_numpy(idx), halo, SpaceMesh(["cpu"] * n))


FLAGS = {
    "default": {},
    "transparent_move": dict(transparent_pixels_can_move=True,
                             moving_pixels_leave_empty_spot=True),
    "not_to_empty": dict(pixels_can_move_to_empty_spot=False,
                         moving_pixels_leave_empty_spot=True),
    "not_to_filled": dict(pixels_can_move_to_filled_spot=False,
                          moving_pixels_leave_empty_spot=True),
    "leave_empty": dict(moving_pixels_leave_empty_spot=True),
}
LAYOUTS = {"plain": (None, 0), "halo": (4, 0), "halo-mesh": (4, 2)}


def _run_compositors(flags, halo, n_mesh, flow, frames=3, with_jax=True):
    """(port rgb, port state, JAX rgb, JAX state) after ``frames`` updates
    with the random reset drawn from one key chain (the JAX pair is None
    without ``with_jax``)."""
    h, w = flow.shape[:2]
    cfg = dict(reset_mode="random", reset_random_factor=0.1, **flags)
    pixmap = np.random.default_rng(17).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)
    params = core.make_layer_params([LayerConfig(0, **cfg)], h, w,
                                    {0: [(3, None)]}, device="cpu")
    jparams = jcore.make_layer_params([JaxLayerConfig(0, **cfg)], h, w,
                                      {0: [(3, np.ones((h, w), bool))]})
    mesh = SpaceMesh(["cpu"] * n_mesh) if n_mesh else None
    jmesh = jax_space_mesh(n_mesh) if n_mesh else None
    init, step = core.build_compositor(params, h, w, halo=halo, mesh=mesh,
                                       device="cpu")
    jinit, jstep = jcore.build_compositor(jparams, h, w, halo=halo,
                                          mesh=jmesh)
    state, jstate = init(), jinit()
    key = jax.random.key(3)
    for _ in range(frames):
        key, sub = jax.random.split(key)
        state = step.update(state, torch.from_numpy(flow),
                            ((torch.from_numpy(pixmap),),),
                            np.asarray(jax.random.key_data(sub)), ((0,),),
                            params)
        if with_jax:
            jstate = jstep.update(jstate, jnp.asarray(flow),
                                  ((jnp.asarray(pixmap),),), sub,
                                  ((jnp.int32(0),),), jparams)
    state, rgb = step.render(state, params)
    if not with_jax:
        return rgb, state[0], None, None
    jstate, jrgb = jstep.render(jstate, jparams)
    return rgb, state[0], np.asarray(jrgb), jstate[0]


def _flow(h, w, reach, seed=17):
    rng = np.random.default_rng(seed)
    flow = np.zeros((h, w, 2), np.float32)
    flow[4:20, 8:40] = rng.integers(-reach, reach + 1, (16, 32, 2))
    return flow


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("flags", list(FLAGS))
def test_moveref_flags_match_jax(flags, layout):
    """The flag matrix of tests/test_halo_gather.py:139-172 under each
    gather layout, against the JAX compositor in the same layout: states
    and frames bit-equal, random resets included. Rows reach past the
    halo, so the clamp runs."""
    halo, n_mesh = LAYOUTS[layout]
    rgb, state, jrgb, jstate = _run_compositors(FLAGS[flags], halo, n_mesh,
                                                _flow(24, 48, 6))
    np.testing.assert_array_equal(rgb.numpy(), jrgb)
    for key, value in jstate.items():
        np.testing.assert_array_equal(state[key].numpy(), np.asarray(value),
                                      err_msg=key)


@pytest.mark.parametrize("flags", list(FLAGS))
def test_halo_matches_plain_within_the_halo(flags):
    """|flow| <= halo: the halo'd and sharded gathers give the plain
    gather's frames."""
    flow = _flow(24, 48, 3)
    rgbs = [_run_compositors(FLAGS[flags], halo, n, flow, with_jax=False)[0]
            for halo, n in LAYOUTS.values()]
    for rgb in rgbs[1:]:
        assert torch.equal(rgb, rgbs[0])


@pytest.mark.parametrize("n_mesh", [0, 2], ids=["halo", "halo-mesh"])
def test_leave_empty_vacates_clamped_row_with_halo(n_mesh):
    """|dy| > halo: the value gather reads the clamped row, and the
    leave-empty scatter vacates that same row (test_halo_gather.py:174)."""
    h, w, halo = 16, 8, 2
    params = core.make_layer_params(
        [LayerConfig(0, moving_pixels_leave_empty_spot=True)], h, w,
        {0: [(3, None)]}, device="cpu")[0]
    flow = torch.zeros((h, w, 2))
    flow[4, 3, 1] = 5.0            # dy=5 > halo=2: the gather reads row 6
    alpha = torch.ones((h, w), dtype=torch.uint8)
    channels = {"v": torch.arange(h * w, dtype=torch.int32).reshape(h, w)}
    mesh = SpaceMesh(["cpu"] * n_mesh) if n_mesh else None
    out, new_alpha, _ = core._movement(params, channels, alpha, flow,
                                       halo=halo, mesh=mesh)
    assert int(out["v"][4, 3]) == 6 * w + 3
    assert new_alpha[6, 3] == 0                # clamped source vacated
    assert new_alpha[9, 3] == 1                # true source untouched
