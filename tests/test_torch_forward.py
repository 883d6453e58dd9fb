"""The port's full-sequence `transformer.forward` against the JAX
package's `repro.models.transformer.forward` on the CPU, at float32 on the
SMOKE configs of the six archs the port serves, with the same parameters
(JAX `init_params`, carried over by `repro_torch.bridge`) and the same
numpy-seeded tokens.  Logits agree within 2e-4 (absolute, and relative to
the largest |logit|: f32 sums taken in another order), and the greedy
token of every position is the same.  One case runs a sequence longer than
the query block (lowered to 8 rows), so the blocked causal masks
are covered too."""
import numpy as np
import pytest
import torch

import jax

from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro_torch.bridge import config_from_reference
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.registry import ARCH_NAMES

from _torch_parity import np32, tree_to_torch

pytestmark = pytest.mark.tier1

TOL = 2e-4


@pytest.fixture(scope="module", params=ARCH_NAMES)
def arch(request):
    jcfg = jregistry.get_config(request.param, smoke=True).with_(
        dtype="float32")
    jparams = jtf.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jparams, config_from_reference(jcfg), tree_to_torch(jparams)


def _tokens(vocab, B=2, S=16, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def _close(got, want):
    got, want = np32(got), np32(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_forward_logits_match_jax(arch):
    jcfg, jparams, cfg, params = arch
    toks = _tokens(cfg.vocab_size)
    want = jtf.forward(jparams, jcfg, {"tokens": toks})
    got = tf.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    _close(got, want)


def test_forward_blocks_long_sequences(arch, monkeypatch):
    # 24 positions in query blocks of 8: past every SMOKE window (16)
    jcfg, jparams, cfg, params = arch
    toks = _tokens(cfg.vocab_size, B=1, S=24, seed=1)
    want = jtf.forward(jparams, jcfg, {"tokens": toks})
    monkeypatch.setattr(attn._sdpa_chunked, "__kwdefaults__", {
        "window": None, "chunk": 8})
    got = tf.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    _close(got, want)
