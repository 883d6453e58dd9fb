"""The port's full-sequence `transformer.forward` against the JAX
package's `repro.models.transformer.forward` on the CPU, at float32 on the
SMOKE configs of the ten archs, with the same parameters (JAX
`init_params`, carried over by `repro_torch.bridge`) and the same
numpy-seeded tokens (frame embeddings for musicgen; for llama-3.2-vision
also patch embeddings, `enc`, for its cross layers).  Logits agree within 2e-4 (absolute, and relative to
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


def _batch(cfg, B=2, S=16, seed=0):
    """The forward's numpy batch: tokens or frame embeddings, and enc for
    cross layers."""
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
    else:
        b = {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)}
    if cfg.encoder_tokens:
        b["enc"] = rng.standard_normal(
            (B, cfg.encoder_tokens, cfg.d_model)).astype(np.float32)
    return b


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want):
    got, want = np32(got), np32(want)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= TOL * max(1.0, np.abs(want).max()), err
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_forward_logits_match_jax(arch):
    jcfg, jparams, cfg, params = arch
    batch = _batch(cfg)
    want = jtf.forward(jparams, jcfg, batch)
    got = tf.forward(params, cfg, _torch(batch))
    _close(got, want)


def test_forward_blocks_long_sequences(arch, monkeypatch):
    # 24 positions in query blocks of 8: past every SMOKE window (16)
    jcfg, jparams, cfg, params = arch
    batch = _batch(cfg, B=1, S=24, seed=1)
    want = jtf.forward(jparams, jcfg, batch)
    monkeypatch.setattr(attn._sdpa_chunked, "__kwdefaults__", {
        "window": None, "chunk": 8})
    got = tf.forward(params, cfg, _torch(batch))
    _close(got, want)
