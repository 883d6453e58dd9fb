"""The port's Mamba2 (SSD) block (`repro_torch.models.ssm`) against the JAX
package's `repro.models.ssm` on the CPU, at float32, on parameters and
inputs made from a numpy seed (A_log, D and dt_bias drawn too, not left at
their zero init).  Tolerance: 1e-5 absolute + 1e-5 relative (f32 sums
taken in another order).  Covered: `ssm_forward` in one chunk and, with
SSD_CHUNK lowered to 8 in both packages, across three chunks (the state
carried between them); `ssm_prefill` — the final state and the conv tail,
zero-padded in front of a prompt shorter than CONV_K - 1 — then
`ssm_decode` steps; the reference's ValueError when the sequence is not a
whole number of chunks; and prefill-then-decode equal to the forward of
the whole sequence."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm

from _torch_parity import np32

pytestmark = pytest.mark.tier1

TOL = dict(rtol=1e-5, atol=1e-5)
D_MODEL, D_INNER, N, H = 32, 64, 8, 4


def _cfgs():
    return (jssm.SsmConfig(D_MODEL, D_INNER, N, H, dtype=jnp.float32),
            ssm.SsmConfig(D_MODEL, D_INNER, N, H, dtype=torch.float32))


def _params(seed=0):
    rng = np.random.default_rng(seed)
    jc, _ = _cfgs()
    out = {}
    for name, s in jssm.ssm_specs(jc).items():
        out[name] = (rng.standard_normal(s.shape) * 0.2).astype(np.float32)
    out["A_log"] = rng.uniform(-1.0, 1.0, H).astype(np.float32)
    out["dt_bias"] = rng.uniform(-2.0, 0.5, H).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _x(S, B=2, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, D_MODEL)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want):
    np.testing.assert_allclose(np32(got), np32(want), **TOL)


@pytest.fixture
def chunk8(monkeypatch):
    monkeypatch.setattr(jssm, "SSD_CHUNK", 8)
    monkeypatch.setattr(ssm, "SSD_CHUNK", 8)


@pytest.mark.parametrize("S", (1, 16))
def test_forward_one_chunk_matches_jax(S):
    (jc, c), (jp, p), (jx, x) = _cfgs(), _params(), _x(S)
    _close(ssm.ssm_forward(p, c, x), jssm.ssm_forward(jp, jc, jx))


def test_forward_carries_state_across_chunks(chunk8):
    (jc, c), (jp, p), (jx, x) = _cfgs(), _params(2), _x(24, seed=3)
    _close(ssm.ssm_forward(p, c, x), jssm.ssm_forward(jp, jc, jx))


@pytest.mark.parametrize("S", (2, 5, 24))
def test_prefill_then_decode_matches_jax(S, chunk8):
    (jc, c), (jp, p) = _cfgs(), _params(4)
    jx, x = _x(S, seed=5)
    jy, jst = jssm.ssm_prefill(jp, jc, jx)
    y, st = ssm.ssm_prefill(p, c, x)
    _close(y, jy)
    assert set(st) == set(jst) == {"s", "conv"}
    for k in st:
        assert tuple(st[k].shape) == jst[k].shape
        _close(st[k], jst[k])
    for t in range(3):
        ju, u = _x(1, seed=10 + t)
        jy, jst = jssm.ssm_decode(jp, jc, ju, jst)
        y, st = ssm.ssm_decode(p, c, u, st)
        _close(y, jy)
        _close(st["s"], jst["s"])
        _close(st["conv"], jst["conv"])


def test_indivisible_sequence_raises_as_the_reference(chunk8):
    (jc, c), (jp, p), (jx, x) = _cfgs(), _params(), _x(20)
    with pytest.raises(ValueError, match="divisible"):
        jssm.ssm_forward(jp, jc, jx)
    with pytest.raises(ValueError, match="divisible"):
        ssm.ssm_forward(p, c, x)


def test_prefill_then_decode_is_the_forward(chunk8):
    # the recurrence and the chunked form agree inside the port
    _, c = _cfgs()
    _, p = _params(6)
    _, x = _x(16, seed=7)
    full = ssm.ssm_forward(p, c, x)
    y, st = ssm.ssm_prefill(p, c, x[:, :8])
    outs = [y]
    for t in range(8, 16):
        y, st = ssm.ssm_decode(p, c, x[:, t:t + 1], st)
        outs.append(y)
    np.testing.assert_allclose(np32(torch.cat(outs, 1)), np32(full),
                               rtol=1e-4, atol=1e-4)
