"""xLSTM blocks, mLSTM (matrix memory) and sLSTM (scalar memory, exponential
gating), per arXiv:2405.04517: the reference's `repro.models.xlstm` in
torch.

mLSTM state: a head's matrix memory M (hd x hd), normalizer n (hd) and
max-gate m (a scalar), f32.  A sequence runs chunkwise (`MLSTM_CHUNK`
positions a chunk: the quadratic form inside, the exact recurrence across,
a Python loop where the reference scans); decode is one step.
sLSTM state: a head's cell c (hd), normalizer n and max-gate m, f32; a
sequence runs one token at a time (the reference's `lax.scan`).
The projections run `kernels.ops.dense` (the CUDA gpp_matmul on the card;
the output gates with the sigmoid fused into its epilogue); the gate maths
is plain torch in f32, as the reference's is jnp.

Under a mesh whose model axis is larger than one rank (`dist.collectives.
tp_par`), given the layer's specs: the heads form when the heads divide
the axis, a copy of x at the entry and a reduce after the row-parallel
output projection —
  mLSTM  w_q / w_k / w_v (stored split on head_dim) taken to the rank's
         heads, w_i / w_f and the gate biases cut to them, w_o
         row-parallel, reduced before the output gate; the output gate
         (`ogate`) computed whole on every model rank from the replicated x
  sLSTM  w_z / w_og / w_i / w_f (stored in head order) and the biases cut
         to the rank's heads, w_out row-parallel
The state the step returns stays whole on every model rank
(`cache_pspecs` places it so): a rank's heads are cut from it and gathered
back.  Otherwise the whole form: every model rank computes the layer
whole (xlstm-1.3b's 4 heads at the production mesh's 16 model ranks).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist.collectives import (LocalLayer, take, tp_par,
                                          whole_layer)
from repro_torch.kernels.ops import dense
from repro_torch.models.layers import Spec

MLSTM_CHUNK = 256  # positions a chunk of the quadratic form


@dataclasses.dataclass(frozen=True)
class XlstmConfig:
    d_model: int
    n_heads: int
    dtype: torch.dtype = torch.bfloat16
    dense_mode: str = "auto"   # kernels.ops.dense routing

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def _log_sigmoid(f: torch.Tensor) -> torch.Tensor:
    # -softplus(-f), softplus as jax.nn.softplus: logaddexp(., 0)
    return -torch.logaddexp(-f, torch.zeros_like(f))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_specs(c: XlstmConfig) -> dict:
    d, h, hd = c.d_model, c.n_heads, c.head_dim
    return {
        "w_q": Spec((d, h, hd), c.dtype),
        "w_k": Spec((d, h, hd), c.dtype),
        "w_v": Spec((d, h, hd), c.dtype),
        "w_i": Spec((d, h), c.dtype),       # input gate (exp)
        "w_f": Spec((d, h), c.dtype),       # forget gate
        "b_i": Spec((h,), torch.float32),
        "b_f": Spec((h,), torch.float32),
        "w_o": Spec((h, hd, d), c.dtype),
        "ogate": Spec((d, d), c.dtype),
    }


def mlstm_state_specs(c: XlstmConfig, batch: int) -> dict:
    h, hd = c.n_heads, c.head_dim
    return {"M": Spec((batch, h, hd, hd), torch.float32),
            "n": Spec((batch, h, hd), torch.float32),
            "m": Spec((batch, h), torch.float32)}


def _mlstm_gates(p, c: XlstmConfig, x):
    i = dense(x, p["w_i"], mode=c.dense_mode).float() + p["b_i"]
    f = dense(x, p["w_f"], mode=c.dense_mode).float() + p["b_f"]
    return i, _log_sigmoid(f)


def _mlstm_qkv(p, c: XlstmConfig, x):
    q = dense(x, p["w_q"], mode=c.dense_mode).float()
    k = dense(x, p["w_k"], mode=c.dense_mode).float() / (c.head_dim ** 0.5)
    v = dense(x, p["w_v"], mode=c.dense_mode).float()
    return q, k, v


def _mlstm_state0(c: XlstmConfig, B: int, device) -> dict:
    h, hd = c.n_heads, c.head_dim
    return {"M": torch.zeros((B, h, hd, hd), device=device),
            "n": torch.zeros((B, h, hd), device=device),
            "m": torch.full((B, h), -1e30, device=device)}


def _mlstm_chunk_scan(p, c: XlstmConfig, x):
    """Chunkwise-parallel mLSTM from the zero state.  Returns (hidden
    (B, S, h, hd) f32, final state)."""
    B, S, _ = x.shape
    L = min(MLSTM_CHUNK, S)
    if S % L:
        raise ValueError(f"seq len {S} must be divisible by chunk {L}")
    q, k, v = _mlstm_qkv(p, c, x)
    i, logf = _mlstm_gates(p, c, x)                    # (B, S, h)
    causal = torch.tril(torch.ones(L, L, dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    st = _mlstm_state0(c, B, x.device)
    hids = []
    for a in range(0, S, L):
        qc, kc, vc = q[:, a:a + L], k[:, a:a + L], v[:, a:a + L]
        ic = i[:, a:a + L]
        M0, n0, m0 = st["M"], st["n"], st["m"]
        Fc = torch.cumsum(logf[:, a:a + L], dim=1)     # log decay in chunk
        # inside: D_ts = F_t - F_s + i_s (s <= t)
        logits = Fc[:, :, None, :] - Fc[:, None, :, :] + ic[:, None, :, :]
        logits = logits.masked_fill(~causal, float("-inf"))
        m_intra = logits.amax(dim=2)                    # (B, L, h)
        log_inter = Fc + m0[:, None, :]
        m_t = torch.maximum(m_intra, log_inter)
        dmat = torch.exp(logits - m_t[:, :, None, :])   # (B, t, s, h)
        scores = torch.einsum("bthk,bshk->btsh", qc, kc) * dmat
        w_inter = torch.exp(log_inter - m_t)            # (B, L, h)
        num = (torch.einsum("btsh,bshk->bthk", scores, vc)
               + w_inter[..., None] * torch.einsum("bthk,bhkv->bthv",
                                                   qc, M0))
        den = (torch.einsum("btsh,bshk->bth", scores, kc)
               + w_inter * torch.einsum("bthk,bhk->bth", qc, n0))
        den = torch.maximum(den.abs(), torch.exp(-m_t))
        hids.append(num / den[..., None])
        # the state at the chunk's end
        Fl = Fc[:, -1:, :]
        logw = Fl - Fc + ic                             # weight of step s
        m_new = torch.maximum(Fl[:, 0] + m0, logw.amax(dim=1))
        wst = torch.exp(logw - m_new[:, None])
        carry = torch.exp(Fl[:, 0] + m0 - m_new)
        st = {"M": carry[..., None, None] * M0
              + torch.einsum("bsh,bshk,bshv->bhkv", wst, kc, vc),
              "n": carry[..., None] * n0
              + torch.einsum("bsh,bshk->bhk", wst, kc),
              "m": m_new}
    return torch.cat(hids, dim=1), st


# the heads dim of each state leaf
MLSTM_HEAD_DIMS = {"M": 1, "n": 1, "m": 1}
SLSTM_HEAD_DIMS = {"c": 1, "n": 1, "m": 1}


def _tp(p, c: XlstmConfig, spec, wants: dict, dims: dict,
        whole=()) -> LocalLayer:
    """The rank's view of one xLSTM layer on the ambient mesh (module
    docstring): each leaf taken to `wants` in the heads form (the leaves
    in `whole` made whole for replicated work), or every leaf whole; no
    mesh or no spec: the layer as it is."""
    par = tp_par()
    if par is None or spec is None:
        return LocalLayer(p, c)
    if c.n_heads % par.tp:
        return LocalLayer(whole_layer(p, spec, par), c)
    w = {n: take(t, spec[n], None, par, partial=False) if n in whole
         else take(t, spec[n], wants[n], par) for n, t in p.items()}
    cl = dataclasses.replace(c, d_model=c.d_model // par.tp,
                             n_heads=c.n_heads // par.tp)
    return LocalLayer(w, cl, par, True, dims)


_HEADS3 = (None, "model", None)
_COLS = (None, "model")
_MLSTM_WANTS = {"w_q": _HEADS3, "w_k": _HEADS3, "w_v": _HEADS3,
                "w_i": _COLS, "w_f": _COLS, "b_i": ("model",),
                "b_f": ("model",), "w_o": ("model", None, None)}
_SLSTM_WANTS = {"w_z": _COLS, "w_og": _COLS, "w_i": _COLS, "w_f": _COLS,
                "b_i": ("model",), "b_f": ("model",),
                "w_out": ("model", None)}


def _mlstm_tp(p, c: XlstmConfig, spec) -> LocalLayer:
    return _tp(p, c, spec, _MLSTM_WANTS, MLSTM_HEAD_DIMS, whole=("ogate",))


def mlstm_prefill(p, c: XlstmConfig, x: torch.Tensor, spec=None):
    """Returns (y, final state).  x: (B, S, D)."""
    lo = _mlstm_tp(p, c, spec)
    hid, state = _mlstm_chunk_scan(lo.p, lo.c, lo.enter(x))
    o = dense(x, lo.p["ogate"], activation="sigmoid", mode=c.dense_mode)
    y = lo.leave(dense(hid.to(x.dtype), lo.p["w_o"], mode=c.dense_mode,
                       contract_dims=2)) * o
    return y, lo.join(state)


def mlstm_forward(p, c: XlstmConfig, x: torch.Tensor,
                  spec=None) -> torch.Tensor:
    return mlstm_prefill(p, c, x, spec)[0]


def mlstm_decode(p, c: XlstmConfig, x: torch.Tensor, state, spec=None):
    """One recurrence step.  x: (B, 1, D).  Returns (y, new state)."""
    lo = _mlstm_tp(p, c, spec)
    state = lo.cut(state)
    x0 = x[:, 0]
    xin = lo.enter(x0)
    q, k, v = _mlstm_qkv(lo.p, lo.c, xin)
    i, logf = _mlstm_gates(lo.p, lo.c, xin)
    m_new = torch.maximum(logf + state["m"], i)
    fw = torch.exp(logf + state["m"] - m_new)[..., None]
    iw = torch.exp(i - m_new)[..., None]
    M = state["M"] * fw[..., None] + iw[..., None] * k[..., None] \
        * v[..., None, :]
    n = state["n"] * fw + iw * k
    num = torch.einsum("bhk,bhkv->bhv", q, M)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", q, n).abs(),
                        torch.exp(-m_new))
    out = (num / den[..., None]).to(x.dtype)
    o = dense(x0, lo.p["ogate"], activation="sigmoid", mode=c.dense_mode)
    y = lo.leave(dense(out, lo.p["w_o"], mode=c.dense_mode,
                       contract_dims=2)) * o
    return y[:, None], lo.join({"M": M, "n": n, "m": m_new})


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_specs(c: XlstmConfig) -> dict:
    d, h = c.d_model, c.n_heads
    return {
        "w_z": Spec((d, d), c.dtype), "w_i": Spec((d, h), c.dtype),
        "w_f": Spec((d, h), c.dtype), "w_og": Spec((d, d), c.dtype),
        "b_i": Spec((h,), torch.float32), "b_f": Spec((h,), torch.float32),
        "w_out": Spec((d, d), c.dtype),
    }


def slstm_state_specs(c: XlstmConfig, batch: int) -> dict:
    return {"c": Spec((batch, c.n_heads, c.head_dim), torch.float32),
            "n": Spec((batch, c.n_heads), torch.float32),
            "m": Spec((batch, c.n_heads), torch.float32)}


def _slstm_step(state, z_t, i_t, logf_t):
    m_new = torch.maximum(logf_t + state["m"], i_t)
    fw = torch.exp(logf_t + state["m"] - m_new)
    iw = torch.exp(i_t - m_new)
    cell = state["c"] * fw[..., None] + iw[..., None] * z_t
    n = state["n"] * fw + iw
    h = cell / torch.clamp(n, min=1.0)[..., None]
    return {"c": cell, "n": n, "m": m_new}, h


def _slstm_inputs(p, c: XlstmConfig, x):
    B, S, _ = x.shape
    z = torch.tanh(dense(x, p["w_z"], mode=c.dense_mode).float()).reshape(
        B, S, c.n_heads, c.head_dim)
    i = dense(x, p["w_i"], mode=c.dense_mode).float() + p["b_i"]
    f = dense(x, p["w_f"], mode=c.dense_mode).float() + p["b_f"]
    og = dense(x, p["w_og"], activation="sigmoid", mode=c.dense_mode)
    return z, i, _log_sigmoid(f), og


def _slstm_tp(p, c: XlstmConfig, spec) -> LocalLayer:
    return _tp(p, c, spec, _SLSTM_WANTS, SLSTM_HEAD_DIMS)


def slstm_prefill(p, c: XlstmConfig, x: torch.Tensor, spec=None):
    """Returns (y, final state): the recurrence one token at a time."""
    lo = _slstm_tp(p, c, spec)
    p, c = lo.p, lo.c
    B, S, _ = x.shape
    z, i, logf, og = _slstm_inputs(p, c, lo.enter(x))
    st = {"c": torch.zeros((B, c.n_heads, c.head_dim), device=x.device),
          "n": torch.zeros((B, c.n_heads), device=x.device),
          "m": torch.full((B, c.n_heads), -1e30, device=x.device)}
    hs = []
    for t in range(S):
        st, h = _slstm_step(st, z[:, t], i[:, t], logf[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, c.d_model).to(x.dtype)
    return (lo.leave(dense(h * og, p["w_out"], mode=c.dense_mode)),
            lo.join(st))


def slstm_forward(p, c: XlstmConfig, x: torch.Tensor,
                  spec=None) -> torch.Tensor:
    return slstm_prefill(p, c, x, spec)[0]


def slstm_decode(p, c: XlstmConfig, x: torch.Tensor, state, spec=None):
    """One recurrence step.  x: (B, 1, D).  Returns (y, new state)."""
    lo = _slstm_tp(p, c, spec)
    p, c = lo.p, lo.c
    z, i, logf, og = _slstm_inputs(p, c, lo.enter(x))
    new_state, h = _slstm_step(lo.cut(state), z[:, 0], i[:, 0], logf[:, 0])
    y = dense(h.reshape(x.shape[0], c.d_model).to(x.dtype) * og[:, 0],
              p["w_out"], mode=c.dense_mode)
    return lo.leave(y)[:, None], lo.join(new_state)
