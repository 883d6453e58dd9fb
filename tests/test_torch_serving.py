"""The port's paged serving engine and CLI against the JAX package's on the
CPU: greedy token streams at float32 on qwen1.5-0.5b SMOKE, on
deepseek-v2-lite-16b SMOKE (MLA + MoE) and on the SMOKE configs of
qwen2-7b, h2o-danube-1.8b, gemma3-12b and kimi-k2 (`NEW_ARCHS`), with the
same parameters (JAX `init_params`, carried over by `repro_torch.bridge`)
and the same requests.  Greedy streams must be equal token for token.
Full kimi-k2 (1.03 T parameters, 61 layers of 384 experts) fits no single
card: its parity with the reference stands here, at SMOKE, and the card
serves it at full width with 2 of its layers (`chip_smoke.py`)."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.bridge import config_from_reference
from repro_torch.serving.engine import (ServeConfig, ServingEngine,
                                        make_engine, sample_token)

from _torch_parity import tree_to_torch

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
SERVE = dict(slots=2, max_len=64)


def _prompts(vocab, n=3, seed=0):
    rng = np.random.default_rng(seed)
    # repeated tails give the n-gram drafter something to propose
    out = []
    for _ in range(n):
        p = rng.integers(0, vocab, size=rng.integers(4, 12)).tolist()
        out.append(p + p[-3:])
    return out


@pytest.fixture(scope="module")
def smoke():
    jcfg = jregistry.get_config("qwen1.5-0.5b", smoke=True).with_(
        dtype="float32")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, config_from_reference(jcfg), tree_to_torch(jparams)


def _run(engine, prompts, max_new=6):
    rids = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    res = engine.run()
    return [res[r] for r in rids]


@pytest.fixture(scope="module")
def jax_streams(smoke):
    jcfg, jparams, _, _ = smoke
    prompts = _prompts(jcfg.vocab_size)
    return {spec: _run(JServingEngine(jcfg, jparams, JServeConfig(
        speculation=spec, **SERVE)), prompts) for spec in (False, True)}


class TestEngineParity:
    @pytest.mark.parametrize("spec", (False, True))
    def test_greedy_streams_match_jax(self, smoke, jax_streams, spec):
        jcfg, _, cfg, params = smoke
        eng = ServingEngine(cfg, params, ServeConfig(
            speculation=spec, device="cpu", **SERVE))
        got = _run(eng, _prompts(cfg.vocab_size))
        assert got == jax_streams[spec]
        if spec:
            assert eng.metrics.total("drafted_tokens") > 0

    def test_speculation_on_off_identical(self, smoke):
        _, _, cfg, params = smoke
        prompts = _prompts(cfg.vocab_size, seed=1)
        off = _run(make_engine(cfg, params, ServeConfig(device="cpu",
                                                        **SERVE)), prompts)
        on = make_engine(cfg, params, ServeConfig(
            speculation=True, draft_len=3, device="cpu", **SERVE))
        assert _run(on, prompts) == off

    def test_step_shapes_stay_bounded(self, smoke):
        _, _, cfg, params = smoke
        eng = ServingEngine(cfg, params, ServeConfig(
            speculation=True, device="cpu", **SERVE))
        # prompt lengths across chunk boundaries and more requests than lanes
        prompts = [list(range(1, n + 1)) * 2 for n in (2, 9, 17, 3, 11)]
        _run(eng, prompts, max_new=5)
        counts = eng.trace_counts     # decode-phase steps all ride verify
        assert counts["prefill_chunk"] == 1 and counts["verify"] == 1
        assert counts["decode"] <= 1
        plain = ServingEngine(cfg, params, ServeConfig(device="cpu", **SERVE))
        _run(plain, prompts[:2], max_new=3)
        assert plain.trace_counts == {"prefill_chunk": 1, "decode": 1,
                                      "verify": 0}

    def test_ledger_matches_jax(self, smoke):
        jcfg, jparams, cfg, params = smoke
        prompts = _prompts(cfg.vocab_size, n=2, seed=2)
        je = JServingEngine(jcfg, jparams, JServeConfig(**SERVE))
        pe = ServingEngine(cfg, params, ServeConfig(device="cpu", **SERVE))
        _run(je, prompts)
        _run(pe, prompts)
        keys = ("tokens", "prefill_tokens", "decode_tokens", "blocks_in_use",
                "param_bytes", "kv_write_bytes", "kv_read_bytes",
                "attn_bytes_gather", "attn_bytes_stream", "hbm_bytes")
        assert [[r[k] for k in keys] for r in pe.metrics] == \
            [[r[k] for k in keys] for r in je.metrics]

    def test_unported_options_raise(self, smoke):
        _, _, cfg, params = smoke
        for kw in (dict(prefix_cache=True), dict(obs=True),
                   dict(draft_source="model")):
            with pytest.raises(NotImplementedError):
                ServingEngine(cfg, params, ServeConfig(device="cpu", **kw))

    def test_cuda_is_the_default_device(self, smoke):
        _, _, cfg, params = smoke
        if torch.cuda.is_available():
            pytest.skip("this host has CUDA")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ServingEngine(cfg, params, ServeConfig())


@pytest.fixture(scope="module")
def deepseek():
    jcfg = jregistry.get_config("deepseek-v2-lite-16b", smoke=True).with_(
        dtype="float32")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, config_from_reference(jcfg), tree_to_torch(jparams)


@pytest.fixture(scope="module")
def deepseek_prompts(deepseek):
    """Prompts that hold the continuation the model will produce, so the
    n-gram drafter finds drafts: prompt + its greedy stream + its tail."""
    jcfg, jparams, _, _ = deepseek
    base = _prompts(jcfg.vocab_size)
    outs = _run(JServingEngine(jcfg, jparams, JServeConfig(**SERVE)), base)
    return [b + o + b[-3:] for b, o in zip(base, outs)]


class TestDeepseekEngineParity:
    @pytest.mark.parametrize("spec", (False, True))
    def test_greedy_streams_match_jax(self, deepseek, deepseek_prompts,
                                      spec):
        jcfg, jparams, cfg, params = deepseek
        prompts = deepseek_prompts
        want = _run(JServingEngine(jcfg, jparams, JServeConfig(
            speculation=spec, **SERVE)), prompts)
        eng = ServingEngine(cfg, params, ServeConfig(
            speculation=spec, device="cpu", **SERVE))
        assert _run(eng, prompts) == want
        if spec:
            assert eng.metrics.total("drafted_tokens") > 0
        assert eng.trace_counts["prefill_chunk"] == 1
        assert eng.trace_counts["decode"] <= 1
        assert eng.trace_counts["verify"] == (1 if spec else 0)


NEW_ARCHS = ("qwen2-7b", "h2o-danube-1.8b", "gemma3-12b", "kimi-k2-1t-a32b")
# enough new tokens to carry every lane past the SMOKE windows of 16
NEW_MAX_NEW = 24


@pytest.fixture(scope="module", params=NEW_ARCHS)
def new_arch(request):
    """(jcfg, jparams, cfg, params, prompts) at f32 SMOKE; the prompts hold
    their greedy continuation (so the n-gram drafter finds drafts)."""
    jcfg = jregistry.get_config(request.param, smoke=True).with_(
        dtype="float32")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    base = _prompts(jcfg.vocab_size)
    outs = _run(JServingEngine(jcfg, jparams, JServeConfig(**SERVE)), base,
                max_new=8)
    prompts = [b + o + b[-3:] for b, o in zip(base, outs)]
    return (jcfg, jparams, config_from_reference(jcfg),
            tree_to_torch(jparams), prompts)


class TestNewArchEngineParity:
    @pytest.mark.parametrize("spec", (False, True))
    def test_greedy_streams_match_jax(self, new_arch, spec):
        jcfg, jparams, cfg, params, prompts = new_arch
        je = JServingEngine(jcfg, jparams, JServeConfig(speculation=spec,
                                                        **SERVE))
        want = _run(je, prompts, max_new=NEW_MAX_NEW)
        eng = ServingEngine(cfg, params, ServeConfig(
            speculation=spec, device="cpu", **SERVE))
        assert _run(eng, prompts, max_new=NEW_MAX_NEW) == want
        assert max(len(p) for p in prompts) + NEW_MAX_NEW > 16
        if spec:
            assert eng.metrics.total("drafted_tokens") > 0
        assert eng.trace_counts["prefill_chunk"] == 1
        assert eng.trace_counts["decode"] <= 1
        assert eng.trace_counts["verify"] == (1 if spec else 0)
        # the same blocks in use at every step (window expiry included)
        assert [m["blocks_in_use"] for m in eng.metrics] == \
            [m["blocks_in_use"] for m in je.metrics]


class TestWindowPlateau:
    """A window group's blocks plateau while a global group's grow with the
    context (the reference's `TestWindowReclamation`), lane by lane through
    the port's per-group tables, with the JAX engine's streams."""

    @pytest.mark.parametrize("arch", ("h2o-danube-1.8b", "gemma3-12b"))
    def test_window_group_plateaus(self, arch):
        jcfg = jregistry.get_config(arch, smoke=True).with_(dtype="float32")
        jparams = jtf.init_params(jcfg, jax.random.PRNGKey(1))
        cfg = config_from_reference(jcfg)
        serve = dict(slots=1, max_len=64, block_size=8, prefill_chunk=8)
        eng = ServingEngine(cfg, tree_to_torch(jparams),
                            ServeConfig(device="cpu", **serve))
        rid = eng.submit(list(range(1, 9)), max_new_tokens=40)
        peak = [0] * eng.kv.num_groups
        while eng.pending:
            eng.step()
            for gi, g in enumerate(eng.kv.groups):
                peak[gi] = max(peak[gi], len(g.blocks_for(0)))
        out = eng.result(rid)
        je = JServingEngine(jcfg, jparams, JServeConfig(**serve))
        jid = je.submit(list(range(1, 9)), max_new_tokens=40)
        assert out == je.run()[jid] and len(out) == 40
        # 48 tokens of context = 6 blocks; a 16-token window needs at most
        # 2 visible blocks + the one being written
        for h, p in zip(eng.group_horizons, peak):
            assert p <= (3 if h else 6) and (h or p == 6)
        assert (None in eng.group_horizons) == (arch == "gemma3-12b")


class TestSampling:
    def test_temperature_draws_are_keyed_not_stateful(self):
        serve = ServeConfig(temperature=0.8, seed=3)
        logits = np.random.default_rng(0).standard_normal(512)
        a = [sample_token(serve, 7, i, logits) for i in range(20)]
        b = [sample_token(serve, 7, i, logits) for i in range(20)]
        assert a == b and len(set(a)) > 1
        assert sample_token(ServeConfig(), 7, 0, logits) == \
            int(np.argmax(logits))


class TestCli:
    def _cli(self, *args, arch="qwen1.5-0.5b"):
        env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
               "JAX_PLATFORMS": "cpu"}
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve",
             "--arch", arch, "--smoke", *args],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)

    def test_serve_runs_on_cpu_when_asked(self):
        r = self._cli("--device", "cpu", "--requests", "3", "--max-new", "4",
                      "--slots", "2", "--max-len", "64", "--speculation")
        assert r.returncode == 0, r.stderr
        assert "3 requests, 12 tokens" in r.stdout
        assert "'prefill_chunk': 1" in r.stdout

    def test_deepseek_serves_on_cpu_when_asked(self):
        r = self._cli("--device", "cpu", "--requests", "3", "--max-new", "4",
                      "--slots", "2", "--max-len", "64", "--speculation",
                      arch="deepseek-v2-lite-16b")
        assert r.returncode == 0, r.stderr
        assert "3 requests, 12 tokens" in r.stdout
        assert "'prefill_chunk': 1" in r.stdout

    @pytest.mark.parametrize("arch", NEW_ARCHS)
    def test_new_archs_serve_on_cpu_when_asked(self, arch):
        r = self._cli("--device", "cpu", "--requests", "3", "--max-new", "4",
                      "--slots", "2", "--max-len", "64", "--speculation",
                      arch=arch)
        assert r.returncode == 0, r.stderr
        assert "3 requests, 12 tokens" in r.stdout
        assert "'prefill_chunk': 1" in r.stdout

    def test_serve_without_cuda_raises(self):
        if torch.cuda.is_available():
            pytest.skip("this host has CUDA")
        r = self._cli("--requests", "1", "--max-new", "2")
        assert r.returncode != 0
        assert "CUDA is not available" in r.stderr
