"""The port's paged serving engine and CLI against the JAX package's on the
CPU: greedy token streams at float32 on qwen1.5-0.5b SMOKE, with the same
parameters (JAX `init_params`, carried over by `repro_torch.bridge`) and
the same requests.  Greedy streams must be equal token for token."""
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
    def _cli(self, *args):
        env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
               "JAX_PLATFORMS": "cpu"}
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve",
             "--arch", "qwen1.5-0.5b", "--smoke", *args],
            capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)

    def test_serve_runs_on_cpu_when_asked(self):
        r = self._cli("--device", "cpu", "--requests", "3", "--max-new", "4",
                      "--slots", "2", "--max-len", "64", "--speculation")
        assert r.returncode == 0, r.stderr
        assert "3 requests, 12 tokens" in r.stdout
        assert "'prefill_chunk': 1" in r.stdout

    def test_serve_without_cuda_raises(self):
        if torch.cuda.is_available():
            pytest.skip("this host has CUDA")
        r = self._cli("--requests", "1", "--max-new", "2")
        assert r.returncode != 0
        assert "CUDA is not available" in r.stderr
