"""Draft-model speculative decoding in the port's engine
(`ServeConfig(draft_source="model")` with `draft_model=(cfg, params)`)
against the JAX package's on the CPU, at float32 SMOKE: a qwen1.5-0.5b
target drafted for by a second qwen1.5-0.5b (other weights), by
deepseek-v2-lite-16b (MLA + MoE; another vocabulary, so drafts are
clamped) and by gemma3-12b (window layers), and by itself (the same
weights, so drafts are accepted).  The greedy streams equal the JAX
engine's with the same draft model, and the port's with speculation off;
the draft model rolls out over one (1, 16) window shape."""
import numpy as np
import pytest

import jax

from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.bridge import config_from_reference
from repro_torch.serving.engine import ServeConfig, ServingEngine, make_engine

from _torch_parity import tree_to_torch

pytestmark = pytest.mark.tier1

SERVE = dict(slots=2, max_len=64, draft_len=3)
DRAFTS = {"other-qwen": ("qwen1.5-0.5b", 1), "self": ("qwen1.5-0.5b", 0),
          "deepseek": ("deepseek-v2-lite-16b", 0), "gemma3": ("gemma3-12b", 0)}


def _model(arch, seed):
    jcfg = jregistry.get_config(arch, smoke=True).with_(dtype="float32")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jparams, config_from_reference(jcfg), tree_to_torch(jparams)


@pytest.fixture(scope="module")
def target():
    return _model("qwen1.5-0.5b", 0)


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, n).tolist() for n in (6, 13, 9)]


def _run(engine, prompts):
    rids = [engine.submit(p, max_new_tokens=8) for p in prompts]
    engine.run()
    return [engine.result(r) for r in rids]


@pytest.mark.parametrize("draft", DRAFTS)
def test_draft_model_streams_match_reference(target, draft):
    jcfg, jparams, cfg, params = target
    djcfg, djparams, dcfg, dparams = (target if DRAFTS[draft][1] == 0
                                      and DRAFTS[draft][0] == "qwen1.5-0.5b"
                                      else _model(*DRAFTS[draft]))
    prompts = _prompts(cfg.vocab_size)
    want = _run(JServingEngine(jcfg, jparams, JServeConfig(
        speculation=True, draft_source="model", **SERVE),
        draft_model=(djcfg, djparams)), prompts)
    eng = make_engine(cfg, params, ServeConfig(
        speculation=True, draft_source="model", device="cpu", **SERVE),
        draft_model=(dcfg, dparams))
    assert _run(eng, prompts) == want
    off = ServingEngine(cfg, params, ServeConfig(device="cpu", **SERVE))
    assert _run(off, prompts) == want
    assert eng.draft_forwards > 0
    assert eng.metrics.total("drafted_tokens") == eng.draft_forwards
    assert eng.trace_counts["verify"] == 1
    if draft == "self":
        # the target drafts for itself: every draft is its own greedy token
        assert eng.acceptance_rate() > 0.5


def test_draft_model_needs_speculation_and_source(target):
    _, _, cfg, params = target
    for kw in (dict(draft_source="model"), dict(speculation=True)):
        eng = ServingEngine(cfg, params, ServeConfig(device="cpu", **kw),
                            draft_model=(cfg, params))
        assert eng._draft_params is None
