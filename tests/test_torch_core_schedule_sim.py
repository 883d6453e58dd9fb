"""The port's copies of the schedule IR (`repro_torch.core.schedule`: the
in-situ / naive ping-pong / GPP builders and `Schedule`'s metrics), the
discrete-event simulator (`core.simulator`), the design-space sweeps
(`core.dse`: Fig 6, Table II), the runtime adaptation (`core.runtime_adapt`:
Fig 7) and the measured-timing feedback (`TimingCache`) against the
reference's on the same inputs.  Op lists and integers are equal, floats
within 1e-9 relative."""
import dataclasses
import itertools
import json

import pytest

from repro.core import dse as jdse
from repro.core import runtime_adapt as jra
from repro.core import schedule as jsched
from repro.core import simulator as jsim
from repro.core.analytical import PimConfig as JPimConfig
from repro_torch.core import dse, runtime_adapt
from repro_torch.core import schedule as sched
from repro_torch.core import simulator as sim
from repro_torch.core.analytical import PimConfig

from _torch_parity import same_values

pytestmark = pytest.mark.tier1

# (n_in, band): compute-bound, matched (t_pim == t_rw at n_in 8), rewrite-
# bound, and a bus narrower than the rewriters
POINTS = ((24.0, 128.0), (8.0, 128.0), (2.0, 128.0), (1.0, 16.0),
          (4.0, 512.0))
MACROS = (1, 2, 7, 16)
ROUNDS = (1, 3)


def _pair(n_in, band):
    return (PimConfig(n_in=n_in, band=band), JPimConfig(n_in=n_in,
                                                        band=band))


def _ops(schedule):
    return [dataclasses.astuple(op) for op in schedule.ops]


class TestBuilders:
    @pytest.mark.parametrize("strategy", ("insitu", "naive_pp", "gpp"))
    def test_op_lists_and_metrics(self, strategy):
        for (n_in, band), n, r in itertools.product(POINTS, MACROS, ROUNDS):
            c, jc = _pair(n_in, band)
            got = sched.build(strategy, c, n, r)
            want = jsched.build(strategy, jc, n, r)
            assert _ops(got) == _ops(want)
            assert (got.num_macros, got.strategy) == (want.num_macros,
                                                      want.strategy)
            for m in ("peak_bandwidth", "avg_bandwidth",
                      "bandwidth_idle_fraction", "macro_utilization"):
                same_values(getattr(got, m)(), getattr(want, m)(), path=m)
            same_values(got.makespan, want.makespan)
            same_values(got.bandwidth_profile(64), want.bandwidth_profile(64))

    def test_named_builders_and_group_counts(self):
        for (n_in, band), n in itertools.product(POINTS, MACROS):
            c, jc = _pair(n_in, band)
            assert sched.gpp_group_count(c) == jsched.gpp_group_count(jc)
            same_values(sched.gpp_concurrent_rewriters(c, n),
                        jsched.gpp_concurrent_rewriters(jc, n))
            for name in ("build_insitu", "build_naive_pp", "build_gpp"):
                assert _ops(getattr(sched, name)(c, n, 2)) == \
                    _ops(getattr(jsched, name)(jc, n, 2))
        assert (sched.KIND_REWRITE, sched.KIND_COMPUTE) == \
            (jsched.KIND_REWRITE, jsched.KIND_COMPUTE)

    def test_stream_plan_and_ratio(self):
        for bb, fl, fps, bps in itertools.product(
                (1e3, 2.6e5, 8e6), (0.0, 1e6, 4e9), (67e12, 989e12),
                (8.19e11, 3.35e12)):
            kw = dict(block_bytes=bb, compute_flops=fl, flops_per_s=fps,
                      transfer_bytes_per_s=bps)
            got, want = sched.plan_stream(**kw), jsched.plan_stream(**kw)
            same_values(got, want)
            same_values(got.ratio, want.ratio)


class TestSimulator:
    @pytest.mark.parametrize("strategy", ("insitu", "naive_pp", "gpp"))
    def test_simulate(self, strategy):
        for (n_in, band), n, r in itertools.product(POINTS, MACROS, ROUNDS):
            c, jc = _pair(n_in, band)
            if strategy == "naive_pp" and n == 1:
                # one macro makes one bank: both copies refuse it alike
                for mod, cfg in ((sim, c), (jsim, jc)):
                    with pytest.raises(RuntimeError, match="wedged"):
                        mod.simulate(strategy, cfg, n, r)
                continue
            got = sim.simulate(strategy, c, n, r)
            want = jsim.simulate(strategy, jc, n, r)
            same_values(got, want, path=f"{strategy} {n_in} {band} {n} {r}")
            for prop in ("macro_utilization", "compute_utilization",
                         "bandwidth_utilization", "avg_bandwidth",
                         "throughput"):
                same_values(getattr(got, prop), getattr(want, prop))

    @pytest.mark.parametrize("fn", ("simulate_insitu", "simulate_naive_pp",
                                    "simulate_gpp", "simulate_gpp_scalar"))
    def test_named_simulators(self, fn):
        c, jc = _pair(8.0, 128.0)
        same_values(getattr(sim, fn)(c, 6, 3), getattr(jsim, fn)(jc, 6, 3))


class TestSweeps:
    def test_fig6_sweep(self):
        ratios = [0.25, 0.5, 1.0, 2.0, 4.0]
        c, jc = PimConfig(), JPimConfig()
        same_values(dse.fig6_sweep(c, ratios, workload_rounds=8),
                    jdse.fig6_sweep(jc, ratios, workload_rounds=8))

    def test_table2(self):
        same_values(dse.table2(), jdse.table2())
        for band in (512.0, 100.0, 8.0):
            same_values(dse.table2_theory(band), jdse.table2_theory(band))
            same_values(dse.table2_practice(band),
                        jdse.table2_practice(band))
        same_values(dse.TABLE2_CFG, jdse.TABLE2_CFG)

    def test_fig7_sweep(self):
        same_values(runtime_adapt.fig7_sweep(rounds=4),
                    jra.fig7_sweep(rounds=4))

    @pytest.mark.parametrize("fn", ("adapt_insitu", "adapt_naive_pp",
                                    "adapt_gpp"))
    def test_adapt_points(self, fn):
        c = PimConfig(size_macro=1024, size_ou=32, s=8.0, band=256.0)
        jc = JPimConfig(size_macro=1024, size_ou=32, s=8.0, band=256.0)
        for n in (1.0, 3.0, 16.0):
            same_values(getattr(runtime_adapt, fn)(c, n, 4),
                        getattr(jra, fn)(jc, n, 4))


SAMPLES = [dict(block_bytes=8.4e6, compute_flops=2.1e9, t_dma=3.1e-6,
                t_compute=2.2e-6, measured_on="compiled"),
           dict(block_bytes=8.4e6, compute_flops=2.1e9, t_dma=9.0e-5,
                t_compute=4.0e-5, measured_on="host"),
           dict(block_bytes=2.6e5, compute_flops=4.2e6, t_dma=1.1e-7,
                t_compute=0.0, measured_on="compiled"),
           dict(block_bytes=1.0e6, compute_flops=3.3e8, t_dma=4.0e-7,
                t_compute=5.0e-7, measured_on="compiled")]


class TestTimingCache:
    @staticmethod
    def _both(samples):
        got, want = sched.TimingCache(), jsched.TimingCache()
        for s in samples:
            got.record(**s)
            want.record(**s)
        return got, want

    @pytest.mark.parametrize("n", (1, 2, 4))
    def test_effective_rates(self, n):
        got, want = self._both(SAMPLES[:n])
        assert len(got) == len(want) == n
        same_values(got.effective_rates(), want.effective_rates())

    def test_json_round_trip_across_packages(self, tmp_path):
        got, want = self._both(SAMPLES)
        assert got.to_json() == want.to_json()
        text = json.dumps(want.to_json())
        back = sched.TimingCache.from_json(json.loads(text))
        assert back.to_json() == got.to_json()
        same_values(back.effective_rates(), want.effective_rates())
        path = tmp_path / "bench.json"
        path.write_text(json.dumps(
            {"dense_timing_samples": {"samples": got.to_json()}}))
        assert sched.TimingCache.from_bench_json(str(path)).to_json() == \
            jsched.TimingCache.from_bench_json(str(path)).to_json()
        for s, js in zip(back.samples, want.samples):
            same_values((s.bytes_per_s, s.flops_per_s),
                        (js.bytes_per_s, js.flops_per_s))

    def test_validation_and_default(self):
        assert sched.TIMING_PROVENANCES == jsched.TIMING_PROVENANCES
        bad = (dict(SAMPLES[0], block_bytes=0),
               dict(SAMPLES[0], t_dma=-1.0),
               dict(SAMPLES[0], measured_on="tpu"))
        for kw in bad:
            for cache in (sched.TimingCache(), jsched.TimingCache()):
                with pytest.raises(ValueError):
                    cache.record(**kw)
        for cache in (sched.TimingCache(), jsched.TimingCache()):
            with pytest.raises(ValueError, match="no samples"):
                cache.effective_rates()
        # no plan moves unless a cache is installed
        assert sched.get_default_timing_cache() is None
        tc = self._both(SAMPLES)[0]
        sched.set_default_timing_cache(tc)
        try:
            assert sched.get_default_timing_cache() is tc
        finally:
            sched.set_default_timing_cache(None)
        assert sched.get_default_timing_cache() is None
