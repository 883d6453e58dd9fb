"""The port's dense-cache serving engine
(`repro_torch.serving.dense_engine.DenseServingEngine`) against the JAX
package's `repro.serving.DenseServingEngine` on the CPU, at float32 on the
SMOKE configs of zamba2-2.7b (Mamba2 + the shared attention block),
xlstm-1.3b (mLSTM + sLSTM) and qwen1.5-0.5b (an arch the paged engine also
serves), with the same parameters (JAX `init_params`, carried over by
`repro_torch.bridge`) and the same requests: prompts of different lengths
and more requests than slots, so lanes sit at different positions and
decode runs several position groups a step.  Greedy streams, `trace_counts`
and every ledger row must be equal.  Also: the engine refuses the
embedding-input archs (llama-3.2-vision's cross layers, musicgen's frame
embeddings), `make_engine` sends the recurrent archs to it, obs on serves
the same streams, and without CUDA it raises unless asked for the CPU."""
import numpy as np
import pytest
import torch

import jax

from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro.serving import DenseServingEngine as JDenseEngine
from repro.serving import ServeConfig as JServeConfig
from repro_torch.bridge import config_from_reference
from repro_torch.models import registry
from repro_torch.serving.dense_engine import DenseServingEngine
from repro_torch.serving.engine import ServeConfig, ServingEngine, make_engine

from _torch_parity import tree_to_torch

pytestmark = pytest.mark.tier1

ARCHS = ("zamba2-2.7b", "xlstm-1.3b", "qwen1.5-0.5b")
SERVE = dict(slots=2, max_len=32)
LENGTHS = (5, 8, 5, 6)          # lanes at different positions; refills
MAX_NEW = (4, 6, 3, 5)


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in LENGTHS]


def _run(engine, prompts):
    rids = [engine.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, MAX_NEW)]
    res = engine.run()
    return [res[r] for r in rids]


def _rows(engine):
    return [{k: v for k, v in r.items() if k != "step_wall_us"}
            for r in engine.metrics]


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """One JAX engine run and one port run of the same requests."""
    jcfg = jregistry.get_config(request.param, smoke=True).with_(
        dtype="float32")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    cfg, params = config_from_reference(jcfg), tree_to_torch(jparams)
    prompts = _prompts(cfg.vocab_size)
    je = JDenseEngine(jcfg, jparams, JServeConfig(**SERVE))
    want = _run(je, prompts)
    pe = DenseServingEngine(cfg, params, ServeConfig(device="cpu", **SERVE))
    got = _run(pe, prompts)
    return dict(cfg=cfg, params=params, prompts=prompts, je=je, want=want,
                pe=pe, got=got)


def test_greedy_streams_match_jax(served):
    assert served["got"] == served["want"]
    assert [len(s) for s in served["got"]] == list(MAX_NEW)


def test_trace_counts_match_jax(served):
    # one prefill shape a distinct prompt length, one decode shape
    assert served["pe"].trace_counts == served["je"].trace_counts == {
        "prefill": len(set(LENGTHS)), "decode": 1}


def test_ledger_rows_match_jax(served):
    pe, je = served["pe"], served["je"]
    assert pe._kv_token_bytes == je._kv_token_bytes > 0
    assert _rows(pe) == _rows(je)
    assert pe.flatness_cov() == pytest.approx(je.flatness_cov())
    assert pe.pending == 0
    assert pe.result(0) == served["got"][0]


def test_obs_on_serves_the_same_streams(served):
    cfg, params = served["cfg"], served["params"]
    eng = DenseServingEngine(cfg, params, ServeConfig(device="cpu", obs=True,
                                                      **SERVE))
    assert _run(eng, served["prompts"]) == served["got"]
    names = {e.get("name") for e in eng.obs.trace.events}
    assert {"prefill", "decode", "step"} <= names
    assert eng.obs.requests.summary()["requests_completed"] == len(LENGTHS)
    assert all(r["step_wall_us"] > 0 for r in eng.metrics)


def test_make_engine_picks_by_arch(served):
    cfg, params = served["cfg"], served["params"]
    eng = make_engine(cfg, params, ServeConfig(device="cpu", **SERVE))
    want = ServingEngine if cfg.name == "qwen1.5-0.5b" else DenseServingEngine
    assert type(eng) is want


def test_cuda_is_the_default_device(served):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DenseServingEngine(served["cfg"], served["params"], ServeConfig())


@pytest.mark.parametrize("arch", ("llama-3.2-vision-11b", "musicgen-large"))
def test_embedding_archs_are_refused(arch):
    # the reference's engine passes token ids only too: it raises an
    # AttributeError deep in llama-vision's cross layer (enc is None); the
    # port refuses at construction
    cfg = registry.get_config(arch, smoke=True)
    with pytest.raises(ValueError, match="token ids only"):
        DenseServingEngine(cfg, {}, ServeConfig(device="cpu"))
    with pytest.raises(ValueError, match="token ids only"):
        make_engine(cfg, {}, ServeConfig(device="cpu"))
