"""The plain reference against the port at the configurations' small
(SMOKE) widths on the CPU, in float32: the port's full-sequence forward
and its paged engine's greedy tokens."""
import numpy as np
import pytest
import torch

from bench.lib import manifest as mf
from bench.lib.model_cfg import program_config, published
from bench.lib.weights import make_params
from bench.reference import model as ref

CONFIGS = sorted(p.stem for p in (mf.BENCH / "configs").glob("*.json"))


def _setup(name, dtype="float32"):
    conf = mf.load_json(mf.BENCH / "configs" / f"{name}.json")
    mcfg = program_config(conf, smoke=True).with_(dtype=dtype)
    pub = published(conf, mcfg, smoke=True)
    from repro_torch.models import transformer as tf
    params = make_params(tf.param_specs(mcfg), 2 ** 32 + 7, "cpu",
                         scale=0.2)
    return mcfg, pub, params


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_logits_match(name):
    from repro_torch.models import transformer as tf
    mcfg, pub, params = _setup(name)
    T = 40                                   # past danube's SMOKE window
    toks = torch.randint(0, mcfg.vocab_size, (2, T),
                         generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got = tf.forward(params, mcfg, {"tokens": toks})
    want = ref.logits_at(pub, params, list(toks), [torch.arange(T)] * 2)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("name", CONFIGS)
def test_paged_engine_tokens_are_the_references_first(name):
    """Greedy tokens of the paged engine (chunked prefill, decode over the
    block tables, window blocks reclaimed) are the reference's argmax, or
    within 1e-4 of its best where two logits tie to rounding."""
    from repro_torch.serving.engine import ServeConfig, make_engine
    mcfg, pub, params = _setup(name)
    eng = make_engine(mcfg, params, ServeConfig(
        slots=3, max_len=96, block_size=8, token_budget=19, device="cpu"))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, mcfg.vocab_size, n).astype(np.int32)
               for n in (5, 30, 47)]
    rids = [eng.submit(p, max_new_tokens=12) for p in prompts]
    eng.run()
    for p, rid in zip(prompts, rids):
        out = eng.result(rid)
        seq = torch.as_tensor(np.concatenate([p, out[:-1]]).astype(np.int64))
        lg = ref.logits_at(pub, params, [seq],
                           [torch.arange(len(p) - 1, len(seq))])[0]
        gap = lg.max(dim=-1).values - lg[torch.arange(len(out)),
                                          torch.as_tensor(out)]
        assert float(gap.max()) <= 1e-4 * float(lg.abs().max())


def test_fp8_control_moves_the_logits():
    _, pub, params = _setup(CONFIGS[0])
    seq = torch.arange(20) % 50
    a = ref.logits_at(pub, params, [seq], [torch.arange(20)])[0]
    b = ref.logits_at(pub, params, [seq], [torch.arange(20)], quant="fp8")[0]
    d = float((a - b).abs().max()) / float(a.abs().max())
    assert 1e-3 < d < 0.5
