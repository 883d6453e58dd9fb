"""The port's telemetry (`repro_torch.obs`) against the JAX package's
`repro.obs` on the CPU.

  * `percentile`, `Histogram` (past its decimation cap), `RequestTracker`
    (TTFT / TPOT on an injected clock) and `BandwidthLedger`'s `summary`
    and `utilization_report` (the copied simulator's predicted column)
    give the reference's values on the same rows;
  * `schedule_lane_events` and `paged_lane_events` emit the reference's
    events for the same schedule; `matmul_lane_events` replays the port's
    own sm_90 plan (CTA 0's run of `plan_matmul_tc_sm90` /
    `plan_matmul_fma_sm90`);
  * the engine: greedy streams are the same with obs on and off, obs off
    records nothing, and the trace of a run (written and parsed back)
    holds a span for every request and every step and the modelled kernel
    lanes, with finite TTFT / TPOT; the host time of the step's parts adds
    up to the steps' wall time.
"""
import json
import math

import numpy as np
import pytest

import jax

from repro.kernels import gpp_matmul as jgm
from repro.kernels import paged_attention as jpa
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.obs import ledger as jledger
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch import obs
from repro_torch.bridge import config_from_reference
from repro_torch.core import schedule as sched
from repro_torch.kernels import gpp_matmul as gm
from repro_torch.kernels import paged_attention as pa
from repro_torch.obs import ledger, metrics, trace
from repro_torch.serving.engine import HOST_PHASES, ServeConfig, ServingEngine

from _torch_parity import tree_to_torch

pytestmark = pytest.mark.tier1


class _Clock:
    def __init__(self, times):
        self.times = iter(times)

    def __call__(self):
        return next(self.times)


def test_percentile_and_histogram_match_reference():
    rng = np.random.default_rng(0)
    xs = rng.exponential(size=301).tolist()
    for q in (0, 1, 25, 50, 90, 99, 100):
        assert metrics.percentile(xs, q) == jmetrics.percentile(xs, q)
    assert math.isnan(metrics.percentile([], 50))
    h, jh = metrics.Histogram(max_samples=64), jmetrics.Histogram(
        max_samples=64)
    for x in xs:
        h.observe(x)
        jh.observe(x)
    assert h.summary() == jh.summary() and h.samples == jh.samples


def test_request_tracker_matches_reference():
    rng = np.random.default_rng(1)
    times = np.cumsum(rng.uniform(0.001, 0.1, 64)).tolist()
    t, jt = (metrics.RequestTracker(clock=_Clock(times)),
             jmetrics.RequestTracker(clock=_Clock(times)))
    for tr in (t, jt):
        for rid in range(4):
            tr.on_submit(rid)
        for rid in (2, 0, 3, 1, 0):        # a resume re-samples nothing
            tr.on_first_token(rid)
        for rid, n in ((0, 5), (2, 1), (1, 9), (3, 3)):
            tr.on_finish(rid, n)
    assert t.summary() == jt.summary()
    assert t.summary()["tpot"]["count"] == 3


def _rows(n=40, seed=2):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield dict(tokens=int(rng.integers(1, 40)),
                   prefill_tokens=int(rng.integers(0, 32)),
                   decode_tokens=int(rng.integers(0, 4)),
                   prefix_hit_tokens=int(rng.integers(0, 16)),
                   param_bytes=1_000_000,
                   kv_write_bytes=int(rng.integers(0, 90_000)),
                   kv_read_bytes=int(rng.integers(0, 400_000)),
                   prefix_saved_bytes=int(rng.integers(0, 9_000)),
                   step_wall_us=float(rng.uniform(10, 900)))


@pytest.mark.parametrize("retention", (0, 7))
def test_ledger_summary_and_utilization_match_reference(retention):
    led, jled = (ledger.BandwidthLedger(retention=retention),
                 jledger.BandwidthLedger(retention=retention))
    assert led.utilization_report() == jled.utilization_report()
    for row in _rows():
        led.record(**row)
        jled.record(**row)
    assert led.summary() == jled.summary()
    rep = led.utilization_report(sim_macros=16, sim_rounds=4)
    assert rep == jled.utilization_report(sim_macros=16, sim_rounds=4)
    assert 0 < rep["measured_bw_utilization"] <= 1
    assert 0 < rep["predicted_bw_utilization"] <= 1


def _events(mod, fn, *args, **kw):
    tr = mod.TraceRecorder(clock=lambda: 0.0)
    n = fn(tr, *args, **kw)
    return n, [dict(e) for e in tr.events]


@pytest.mark.parametrize("G", (1, 2, 4))
def test_lane_helpers_replay_the_reference_schedule(G):
    kw = dict(num_steps=37, G=G, C=max(1, G - 1), t0_us=5.0, dur_us=100.0,
              step_bytes=4096.0, live=lambda s: s % 5 != 3, max_events=16)
    assert _events(trace, gm.schedule_lane_events, **kw) == \
        _events(jtrace, jgm.schedule_lane_events, **kw)
    live = [3, 0, 7, 1]
    kw = dict(G=G, block_bytes=2048, t0_us=1.0, dur_us=50.0, pid=3)
    n, evs = _events(trace, pa.paged_lane_events, live, 8, **kw)
    assert (n, evs) == _events(jtrace, jpa.paged_lane_events, live, 8, **kw)
    assert n > 0 and all(e["cat"] == "modeled" for e in evs)


@pytest.mark.parametrize("itemsize,M,K,N", ((2, 32, 1024, 1024),
                                            (2, 4, 10944, 2048),
                                            (4, 4, 2048, 64)))
def test_matmul_lanes_replay_the_sm90_plan(itemsize, M, K, N):
    tr = trace.TraceRecorder(clock=lambda: 0.0)
    n = gm.matmul_lane_events(tr, M, K, N, itemsize=itemsize, t0_us=0.0,
                              dur_us=10.0)
    plan = (sched.plan_matmul_tc_sm90(M, K, N) if itemsize == 2 else
            sched.plan_matmul_fma_sm90(M, K, N, w_itemsize=itemsize))
    compute = [e for e in tr.events if e["name"].endswith("compute")]
    assert n == len(tr.events) > 0
    assert sum(e["args"]["grid_steps"] for e in compute) == \
        plan.cta_steps(0)
    dma = [e for e in tr.events if e["name"].endswith("dma")]
    assert {e["args"]["ring"] for e in dma} == {
        min(plan.num_bufs, plan.cta_steps(0))}


def test_telemetry_factory_and_export(tmp_path):
    on, off = obs.make_telemetry(True, trace_capacity=8), \
        obs.make_telemetry(False)
    assert on.enabled and on.trace.enabled
    assert not off.enabled and off.trace is obs.NULL_TRACE
    with pytest.raises(RuntimeError):
        off.write_metrics(str(tmp_path / "m.jsonl"))
    on.requests.on_submit(0)
    snap = on.write_metrics(str(tmp_path / "m.jsonl"), extra={"x": 1})
    line = json.loads((tmp_path / "m.jsonl").read_text())
    assert line["x"] == 1 and snap["requests"]["requests_submitted"] == 1


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def qwen():
    jcfg = jregistry.get_config("qwen1.5-0.5b", smoke=True).with_(
        dtype="float32")
    return config_from_reference(jcfg), tree_to_torch(
        jtf.init_params(jcfg, jax.random.PRNGKey(0)))


def _serve(cfg, params, on, **kw):
    eng = ServingEngine(cfg, params, ServeConfig(
        slots=2, max_len=64, obs=on, device="cpu", **kw))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() + [7, 8, 7, 8]
               for n in (5, 11, 3)]
    rids = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run()
    return [eng.result(r) for r in rids], eng


@pytest.mark.parametrize("spec", (False, True))
def test_obs_never_changes_tokens(qwen, spec):
    off, e_off = _serve(*qwen, False, speculation=spec, prefix_cache=spec)
    on, e_on = _serve(*qwen, True, speculation=spec, prefix_cache=spec)
    assert on == off
    assert len(e_off.obs.trace) == 0 and not any(e_off.host_us.values())
    assert all(m["step_wall_us"] == 0 for m in e_off.metrics)
    assert all(m["step_wall_us"] > 0 for m in e_on.metrics)


def test_trace_covers_requests_steps_and_lanes(qwen, tmp_path):
    streams, eng = _serve(*qwen, True, trace_capacity=4096)
    path = tmp_path / "trace.json"
    eng.obs.write_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    steps = [e for e in evs if e.get("name") == "step" and e["ph"] == "X"]
    assert len(steps) == len(eng.metrics)
    for ph in ("b", "e"):
        assert sorted(e["id"] for e in evs if e["ph"] == ph
                      and e["pid"] == trace.PID_REQUESTS) == [0, 1, 2]
    assert {e["name"] for e in evs if e.get("cat") == "phase"} >= {
        "prefill_chunk", "decode"}
    assert {e["tid"] for e in evs if e["pid"] == trace.PID_KERNEL
            and e["ph"] == "X"} == {trace.TID_DMA, trace.TID_COMPUTE}
    req = eng.obs.requests.summary()
    for k in ("ttft", "tpot"):
        assert req[k]["count"] == len(streams)
        assert math.isfinite(req[k]["p50"]) and math.isfinite(req[k]["p99"])
    assert set(eng.host_us) == set(HOST_PHASES)
    # the parts partition each step's wall time
    assert sum(eng.host_us.values()) == pytest.approx(
        eng.metrics.total("step_wall_us"), rel=1e-9)
    assert eng.host_us["launch"] > 0
