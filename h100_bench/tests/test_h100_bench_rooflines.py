"""The frozen bound arithmetic against counts made by hand at small
shapes, and the rule that a kernel the trace does not show counts
nothing."""
import pytest

from h100_bench import rooflines as r


class FakeTrace:
    def __init__(self, seconds):
        self._seconds = seconds

    def seconds(self, kind="kernel", name=None):
        return sum(s for n, s in self._seconds.items() if name in n)


def test_fb_bounds_by_hand():
    # 32 x 48, two levels (16 x 24; 8 x 12 stops at poly_n 5's window)
    cv = {"fb_levels": 3, "fb_iterations": 1, "fb_winsize": 3}
    levels = r.fb_levels(32, 48, cv)
    assert [(h, w) for h, w, _ in levels] == [(32, 48), (16, 24)]
    b = r.fb_bounds(32, 48, cv, storage=2)
    px0, px1 = 32 * 48, 16 * 24
    b1_ops = 2 * (18 * 11 + 56) * (px0 + px1)
    assert b["B1"][1] == b1_ops
    assert b["B1"][0] == pytest.approx(
        r.bound_s(2 * px0 * (2 + 10), 2 * 254 * px0)
        + r.bound_s(2 * px1 * (4 + 10), 2 * 254 * px1))
    assert b["B2a"][1] == 99 * (px0 + px1)
    assert b["B2b"][1] == (6 * 4 * 3 + 14) * (px0 + px1)
    assert b["B2b"][0] == pytest.approx(
        r.bound_s(px0 * 28, 86 * px0) + r.bound_s(px1 * 28, 86 * px1))
    # one level change: 16 x 24 -> 32 x 48, two taps each way
    nbytes, ops = r.resize_cost(16, 24, 32, 48)
    assert nbytes == 8 * (px1 + px0)
    assert ops == 2 * px0 + 2 * 32 * 24 * 3 + 2 * px0 * 3
    assert b["B15"][0] == pytest.approx(r.bound_s(nbytes, ops))


def test_comp_bounds_by_hand():
    b = r.comp_bounds(10, 20, 0.5)
    assert b["K1"][0] == pytest.approx(max(200 * 24 / r.HBM_BYTES_PER_S,
                                           200 * 100 / r.F32_FLOPS))
    assert b["K2"][0] == pytest.approx(200 * 7 / r.HBM_BYTES_PER_S)


def test_lfn_launch_counts():
    kinds = [x[0] for x in r.lfn_launches(64, 96)]
    assert (kinds.count("conv"), kinds.count("B7"), kinds.count("B16"),
            kinds.count("B17"), kinds.count("A1")) == (93, 14, 6, 5, 5)


def test_lfn_flops_by_hand():
    # the first convolution alone: both images, 3 -> 32 channels, 7 x 7
    first = r.lfn_launches(64, 96)[0]
    assert first == ("conv", 2, 64, 96, 3, 32, 7, 7, True)
    total = r.lfn_flops(64, 96)
    assert total > 2.0 * 2 * 64 * 96 * 3 * 32 * 49
    assert r.lfn_size(1080, 1920) == (1088, 1920)


def test_share_counts_only_kernels_the_trace_shows():
    bounds = {"B1": (1.0, 0), "B2a": (2.0, 0)}
    trace = FakeTrace({"poly_expansion_kernel<...>": 4.0})
    # B2a is absent: neither its bound nor any time counts
    assert r.share(trace, bounds, frames=1) == pytest.approx(25.0)
    assert r.share(FakeTrace({}), bounds, frames=1) is None
    both = FakeTrace({"poly_expansion_kernel": 4.0,
                      "update_equations_kernel": 4.0})
    assert r.share(both, bounds, frames=2) == pytest.approx(75.0)
