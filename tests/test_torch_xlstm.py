"""The port's xLSTM blocks (`repro_torch.models.xlstm`) against the JAX
package's `repro.models.xlstm` on the CPU, at float32, on parameters and
inputs made from a numpy seed (weights and gate biases drawn at 0.1 x
N(0, 1)).  Tolerance: 1e-5 of the largest |value| of the reference's
output or state (f32 sums taken in another order, divided by the
stabilised normalizer).  With
MLSTM_CHUNK lowered to 8 in both packages (as tests/test_models.py does
for the reference), a 24-token sequence runs three chunks, so the
inter-chunk carry of M, n and the max-stabiliser m runs.  Covered: mLSTM
and sLSTM forward, prefill (output and final state) then decode steps, and
the reference's ValueError when the sequence is not a whole number of
chunks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import xlstm as jxl
from repro_torch.models import xlstm

from _torch_parity import np32

pytestmark = pytest.mark.tier1

TOL = 1e-5
D, H = 32, 2
KINDS = ("mlstm", "slstm")


def _cfgs():
    return (jxl.XlstmConfig(D, H, dtype=jnp.float32),
            xlstm.XlstmConfig(D, H, dtype=torch.float32))


def _params(kind, seed=0):
    rng = np.random.default_rng(seed)
    jc, _ = _cfgs()
    specs = getattr(jxl, f"{kind}_specs")(jc)
    out = {k: (rng.standard_normal(s.shape) * 0.1).astype(np.float32)
           for k, s in specs.items()}
    return ({k: jnp.asarray(v) for k, v in out.items()},
            {k: torch.from_numpy(v) for k, v in out.items()})


def _x(S, B=2, seed=1):
    x = np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _close(got, want):
    got, want = np32(got), np32(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= TOL * max(1.0, np.abs(want).max())


def _fn(kind, step):
    return getattr(jxl, f"{kind}_{step}"), getattr(xlstm, f"{kind}_{step}")


@pytest.fixture
def chunk8(monkeypatch):
    monkeypatch.setattr(jxl, "MLSTM_CHUNK", 8)
    monkeypatch.setattr(xlstm, "MLSTM_CHUNK", 8)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("S", (8, 24))
def test_forward_matches_jax(kind, S, chunk8):
    (jc, c), (jp, p), (jx, x) = _cfgs(), _params(kind), _x(S)
    jf, f = _fn(kind, "forward")
    _close(f(p, c, x), jf(jp, jc, jx))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("S", (3, 24))
def test_prefill_then_decode_matches_jax(kind, S, chunk8):
    (jc, c), (jp, p) = _cfgs(), _params(kind, 2)
    jx, x = _x(S, seed=3)
    jf, f = _fn(kind, "prefill")
    jy, jst = jf(jp, jc, jx)
    y, st = f(p, c, x)
    _close(y, jy)
    assert set(st) == set(jst)
    for k in st:
        assert tuple(st[k].shape) == jst[k].shape
        _close(st[k], jst[k])
    jd, d = _fn(kind, "decode")
    for t in range(3):
        ju, u = _x(1, seed=10 + t)
        jy, jst = jd(jp, jc, ju, jst)
        y, st = d(p, c, u, st)
        _close(y, jy)
        for k in st:
            _close(st[k], jst[k])


def test_mlstm_indivisible_sequence_raises_as_the_reference(chunk8):
    (jc, c), (jp, p), (jx, x) = _cfgs(), _params("mlstm"), _x(20)
    with pytest.raises(ValueError, match="divisible"):
        jxl.mlstm_forward(jp, jc, jx)
    with pytest.raises(ValueError, match="divisible"):
        xlstm.mlstm_forward(p, c, x)


def test_mlstm_chunk_size_does_not_change_the_output(monkeypatch):
    # the chunkwise form is exact: 8-token chunks == one 24-token chunk
    _, c = _cfgs()
    _, p = _params("mlstm", 4)
    _, x = _x(24, seed=5)
    y24 = xlstm.mlstm_forward(p, c, x)
    monkeypatch.setattr(xlstm, "MLSTM_CHUNK", 8)
    np.testing.assert_allclose(np32(xlstm.mlstm_forward(p, c, x)),
                               np32(y24), rtol=1e-4, atol=1e-4)
