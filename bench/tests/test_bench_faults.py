"""A whole run of each cell on the CPU, at the configurations' small
widths in float32, with the harness's look for a card skipped: sound, it comes
out correct; with the timed path broken underneath (a decode step that
leaves the KV cache as it was, half the lanes' logits left out, a token
altered where it is produced), `correct` comes out false.  One card, so
no exchange between cards to leave out.  The serving cells are the test
checkout's (conftest.py)."""
import pytest
import torch

from bench.lib import manifest as mf
from bench.lib.serve import run_serve
from bench.run import run_cell
from conftest import SERVE_CELLS

SERVE = list(SERVE_CELLS)
# small traffic: 8 clients, prompts of 8-60 tokens past the small window
SMALL = {"cell": {"init_scale": 0.2, "dtype": "float32",
                  "window_steps": 40}}


def _run(name, root):
    return run_cell(name, 2 ** 31 + 11, 1.0, False, device="cpu",
                    smoke=True, overrides=SMALL, root=root)


def _stale_cache(monkeypatch):
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "_paged_write_token",
                        lambda pool, *a: pool)


def _half_the_lanes(monkeypatch):
    from repro_torch.models import transformer as tf
    real = tf.decode_step_paged

    def half(*a, **kw):
        logits, caches = real(*a, **kw)
        h = logits.shape[0] // 2
        logits = torch.cat([logits[:h], logits[:logits.shape[0] - h]])
        return logits, caches
    monkeypatch.setattr(tf, "decode_step_paged", half)


def _altered_token(monkeypatch):
    from repro_torch.serving import engine
    real = engine.sample_token

    def altered(serve, rid, idx, row):
        t = real(serve, rid, idx, row)
        return (t + 1) % len(row) if idx % 3 == 2 else t
    monkeypatch.setattr(engine, "sample_token", altered)


@pytest.mark.parametrize("name", SERVE)
def test_sound_run_is_correct(name, bench_root):
    res = _run(name, bench_root)
    assert res["correct"], res["check"]
    assert res["attempted"] > 8 and res["failed"] == 0


@pytest.mark.parametrize("name", SERVE)
def test_window_opens_with_every_lane_decoding(name, bench_root):
    """Set-up's fill leaves each client's first request decoding with a
    residual length to go: all had their first token before the window,
    none finished before it, and their completions spread over it."""
    conf, cell, mix = mf.cell_files(mf.manifest(bench_root), name,
                                    bench_root, SMALL)
    run = run_serve(conf, cell, mix, 2 ** 31 + 17, 1.0, False, "cpu",
                    smoke=True)["run"]
    first = run.requests[:mix["clients"]]
    assert all(r.times and r.times[0] <= run.t0 for r in first)
    assert all(r.done_t is None or r.done_t > run.t0 for r in first)
    done = sorted(r.done_t for r in first if r.done_t is not None)
    assert len(set(done)) >= mix["clients"] // 2


@pytest.mark.parametrize("fault", (_stale_cache, _half_the_lanes,
                                   _altered_token))
@pytest.mark.parametrize("name", SERVE)
def test_broken_run_is_not_correct(name, fault, monkeypatch, bench_root):
    fault(monkeypatch)
    res = _run(name, bench_root)
    assert not res["correct"], res["check"]


TRAIN = [w["name"] for w in mf.manifest()["workloads"]
         if mf.load_json(mf.BENCH / "workloads" / f"{w['name']}.json")
         ["kind"] == "train"]
# two rows of 40 tokens, past the small window of 16
SMALL_JOB = {"mix": {"batch": 2, "seq_len": 40},
             "cell": {"init_scale": 0.2, "dtype": "float32",
                      "window_steps": 3}}


def _train(name, fault=None, trace=False):
    return run_cell(name, 2 ** 31 + 13, 0.5, trace, device="cpu",
                    smoke=True, overrides=SMALL_JOB, fault=fault)


def _returns_its_state(step_fn):
    """A step that computes, then hands back the state it was given."""
    from repro_torch.models.layers import tree_map

    def step(params, state, batch, k):
        _, _, m = step_fn(tree_map(torch.clone, params),
                          tree_map(torch.clone, state), batch, k)
        return params, state, m
    return step


@pytest.mark.parametrize("name", TRAIN)
def test_sound_train_run_is_correct(name):
    res = _train(name)
    assert res["correct"], res["check"]
    assert res["failed"] == 0 and res["attempted"] >= 4


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", ("state", "half_batch"))
def test_broken_train_run_is_not_correct(name, fault):
    from bench.control import half_batch
    res = _train(name, _returns_its_state if fault == "state"
                 else half_batch)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_traced_run_reads_its_layers(name, bench_root):
    """The traced path end to end on the CPU: the telemetry and the
    profiler run, every host-side reader gives a number, and no reader
    gives a device number (there is no device to read)."""
    res = (_train(name, trace=True) if name in TRAIN else run_cell(
        name, 5, 0.5, True, device="cpu", smoke=True, overrides=SMALL,
        root=bench_root))
    assert res["device"]["busy_s"] == 0.0
    m = res["metrics"]
    assert not any("roofline" in k or "device_ms" in k for k in m)
    if name in SERVE:
        assert m["decode_lanes.serve"]["value"] > 0
        assert 0 < m["kv_used_share.serve"]["value"] <= 100
