"""The port's vectorised GPP discrete-event simulator
(`repro_torch.core.simulator.simulate_gpp`) against its own scalar event
loop (`simulate_gpp_scalar`) and against the reference's `simulate_gpp`, on
the reference's grid (`tests/test_sim_vectorized.py`): compute-bound,
balanced and DMA-bound configs, odd macro counts that straddle the stagger
groups, multi-round workloads and an arbiter-saturated bus.  Every
`SimResult` total agrees within 1e-9 relative.  (The reference's wall-clock
assertion is not mirrored: timing under parallel test workers is noise.)"""
import pytest

from repro.core.analytical import PimConfig as JPimConfig
from repro.core.simulator import simulate_gpp as j_simulate_gpp
from repro_torch.core.analytical import PimConfig
from repro_torch.core.simulator import (simulate, simulate_gpp,
                                        simulate_gpp_scalar)

pytestmark = pytest.mark.tier1

FIELDS = ("total_cycles", "compute_cycles", "rewrite_cycles",
          "bytes_transferred", "peak_bandwidth", "bw_busy_cycles")


def assert_same(a, b, ctx):
    for f in FIELDS:
        va, vb = getattr(a, f), getattr(b, f)
        assert abs(va - vb) <= 1e-9 * max(1.0, abs(vb)), (ctx, f, va, vb)
    assert (a.strategy, a.num_macros, a.rounds) == \
        (b.strategy, b.num_macros, b.rounds)


@pytest.mark.parametrize("n_in", [1.0, 2.0, 8.0, 24.0])
@pytest.mark.parametrize("num_macros", [1, 3, 7, 64, 130])
def test_vectorized_matches_scalar_and_reference(n_in, num_macros):
    cfg = PimConfig().with_(n_in=n_in)
    a = simulate_gpp(cfg, num_macros, 4)
    assert_same(a, simulate_gpp_scalar(cfg, num_macros, 4),
                ("scalar", n_in, num_macros))
    assert_same(a, j_simulate_gpp(JPimConfig().with_(n_in=n_in),
                                  num_macros, 4),
                ("reference", n_in, num_macros))


def test_band_limited():
    """Arbiter-saturated regime: bus rate < per-macro s, many rewriters."""
    kw = dict(band=16.0, s=4.0, n_in=4.0)
    a = simulate_gpp(PimConfig(**kw), 96, 6)
    assert_same(a, simulate_gpp_scalar(PimConfig(**kw), 96, 6), "scalar")
    assert_same(a, j_simulate_gpp(JPimConfig(**kw), 96, 6), "reference")


def test_dispatch_uses_vectorized():
    cfg = PimConfig().with_(n_in=8.0)
    assert_same(simulate("gpp", cfg, 64, 8), simulate_gpp(cfg, 64, 8),
                "dispatch")
