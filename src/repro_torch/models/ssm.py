"""Mamba2 (SSD) block, the state-space mixer of Zamba2: the reference's
`repro.models.ssm` in torch.

Per-head scalar decay a_t = exp(-softplus(dt) * A), state
S_t = a_t * S_{t-1} + dt * B_t (x) x_t, y_t = C_t . S_t + D * x_t, with a
depthwise causal conv in front and a gated output projection.  A sequence
runs chunked (`SSD_CHUNK` positions a chunk: the quadratic form inside a
chunk, the state carried across chunks, a Python loop where the reference
scans); decode is one recurrence step on the carried state (`s`, f32) and
the conv's last CONV_K - 1 inputs (`conv`).  The projections run
`kernels.ops.dense` (the CUDA gpp_matmul on the card); the rest is plain
torch in f32, as the reference's is jnp.

Under a mesh whose model axis is larger than one rank (`dist.collectives.
tp_par`), given the layer's specs (`_ssm_tp`): the heads form when the
heads divide the axis — a copy of u at the entry; the rank's heads of x
and of z cut from the whole w_in (stored split on its last dim, which
mixes x and z); w_dt / conv_w / A_log / D / dt_bias cut to the rank's
heads or channels; w_bc (B and C, shared by every head) whole; w_out
row-parallel, then a reduce.  The state the step returns stays whole on
every model rank (`cache_pspecs` places it so): a rank's heads are cut
from it and gathered back.  Otherwise the whole form: every model rank
computes the layer whole.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.dist.collectives import (LocalLayer, take, tp_par,
                                          whole_layer)
from repro_torch.kernels.ops import dense
from repro_torch.models.layers import Spec

CONV_K = 4
SSD_CHUNK = 256  # positions a chunk of the quadratic form


@dataclasses.dataclass(frozen=True)
class SsmConfig:
    d_model: int
    d_inner: int          # typically 2 * d_model
    d_state: int          # N: state dim a channel (zamba2: 64)
    n_heads: int          # channels grouped into heads for dt / A
    dtype: torch.dtype = torch.bfloat16
    dense_mode: str = "auto"   # kernels.ops.dense routing

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


def ssm_specs(c: SsmConfig) -> dict:
    return {
        "w_in": Spec((c.d_model, 2 * c.d_inner), c.dtype),   # x and gate z
        "w_bc": Spec((c.d_model, 2 * c.d_state), c.dtype),   # B and C
        "w_dt": Spec((c.d_model, c.n_heads), c.dtype),
        "conv_w": Spec((CONV_K, c.d_inner), c.dtype),
        "A_log": Spec((c.n_heads,), torch.float32),
        "D": Spec((c.n_heads,), torch.float32),
        "dt_bias": Spec((c.n_heads,), torch.float32),
        "w_out": Spec((c.d_inner, c.d_model), c.dtype),
    }


def ssm_state_specs(c: SsmConfig, batch: int) -> dict:
    return {"s": Spec((batch, c.n_heads, c.head_dim, c.d_state),
                      torch.float32),
            "conv": Spec((batch, CONV_K - 1, c.d_inner), c.dtype)}


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus: logaddexp(x, 0)
    return torch.logaddexp(x, torch.zeros_like(x))


def _conv1d_causal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv.  x: (B, S, Di), w: (K, Di)."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = pad[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pad[:, i:i + S] * w[i]
    return out


def _gates(p, c: SsmConfig, u):
    """B, C, dt (f32, softplus) and the decay a of u: (B, S, D)."""
    bc = dense(u, p["w_bc"], mode=c.dense_mode)
    Bm, Cm = bc.split(c.d_state, dim=-1)                    # (B, S, N)
    dt = _softplus(dense(u, p["w_dt"], mode=c.dense_mode).float()
                   + p["dt_bias"])                          # (B, S, H)
    a = torch.exp(-dt * torch.exp(p["A_log"]))              # in (0, 1)
    return Bm, Cm, dt, a


def _ssd_chunked(p, c: SsmConfig, u: torch.Tensor):
    """Chunked SSD (the Mamba2 duality): the quadratic form inside a chunk,
    the state carried between chunks; per-position (P, N) states are never
    made.  Returns (y (B, S, D), final state (B, H, P, N) f32, the conv's
    input x_raw (B, S, Di))."""
    B_, S, _ = u.shape
    H, P = c.n_heads, c.head_dim
    Lc = min(SSD_CHUNK, S)
    if S % Lc:
        raise ValueError(f"seq len {S} must be divisible by ssd chunk {Lc}")
    x_raw, z = dense(u, p["w_in"], mode=c.dense_mode).split(c.d_inner,
                                                            dim=-1)
    x = F.silu(_conv1d_causal(x_raw, p["conv_w"]))
    Bm, Cm, dt, a = _gates(p, c, u)
    xh = x.reshape(B_, S, H, P).float()
    loga = torch.log(torch.clamp(a, min=1e-30))             # (B, S, H)
    Bf, Cf = Bm.float(), Cm.float()
    causal = torch.tril(torch.ones(Lc, Lc, dtype=torch.bool,
                                   device=u.device))[None, :, :, None]
    s = torch.zeros((B_, H, P, c.d_state), dtype=torch.float32,
                    device=u.device)
    ys = []
    for i in range(0, S, Lc):
        xc, bc, cc = xh[:, i:i + Lc], Bf[:, i:i + Lc], Cf[:, i:i + Lc]
        dtc = dt[:, i:i + Lc]
        A = torch.cumsum(loga[:, i:i + Lc], dim=1)          # (B, Lc, H)
        # inside: y[t] = sum_{s<=t} exp(A_t - A_s) dt_s (C_t . B_s) x_s
        decay = A[:, :, None, :] - A[:, None, :, :]          # (B, t, s, H)
        decay = decay.masked_fill(~causal, float("-inf"))
        gates = torch.exp(decay) * dtc[:, None, :, :]
        scores = torch.einsum("btn,bsn->bts", cc, bc)
        w = gates * scores[..., None]
        y_intra = torch.einsum("btsh,bshp->bthp", w, xc)
        # across: y[t] += exp(A_t) C_t . s_prev
        y_inter = torch.exp(A)[..., None] * torch.einsum(
            "btn,bhpn->bthp", cc, s)
        wA = torch.exp(A[:, -1:, :] - A) * dtc               # (B, Lc, H)
        s = (s * torch.exp(A[:, -1])[..., None, None]
             + torch.einsum("bsh,bshp,bsn->bhpn", wA, xc, bc))
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1) + p["D"][None, None, :, None] * xh
    y = y.reshape(B_, S, H * P).to(u.dtype) * F.silu(z)
    return dense(y, p["w_out"], mode=c.dense_mode), s, x_raw


# the dim of each state leaf that holds the heads (conv: the channels, in
# head order)
STATE_HEAD_DIMS = {"s": 1, "conv": 2}


def _ssm_tp(p, c: SsmConfig, spec) -> LocalLayer:
    """The rank's view of one Mamba2 layer on the ambient mesh (module
    docstring); no mesh or no spec: the layer as it is."""
    par = tp_par()
    if par is None or spec is None:
        return LocalLayer(p, c)
    if c.n_heads % par.tp:
        return LocalLayer(whole_layer(p, spec, par), c)
    tp, r = par.tp, par.rank("model")
    Dl = c.d_inner // tp
    w_in = take(p["w_in"], spec["w_in"], None, par)
    w = {"w_in": torch.cat([w_in.narrow(1, r * Dl, Dl),
                            w_in.narrow(1, c.d_inner + r * Dl, Dl)], 1),
         "w_bc": take(p["w_bc"], spec["w_bc"], None, par),
         "w_dt": take(p["w_dt"], spec["w_dt"], (None, "model"), par),
         "conv_w": take(p["conv_w"], spec["conv_w"], (None, "model"), par),
         "w_out": take(p["w_out"], spec["w_out"], ("model", None), par)}
    for n in ("A_log", "D", "dt_bias"):
        w[n] = take(p[n], spec[n], ("model",), par)
    cl = dataclasses.replace(c, d_inner=Dl, n_heads=c.n_heads // tp)
    return LocalLayer(w, cl, par, True, STATE_HEAD_DIMS)


def ssm_forward(p, c: SsmConfig, u: torch.Tensor, spec=None) -> torch.Tensor:
    """Full-sequence SSD (chunked).  u: (B, S, D)."""
    lo = _ssm_tp(p, c, spec)
    return lo.leave(_ssd_chunked(lo.p, lo.c, lo.enter(u))[0])


def ssm_prefill(p, c: SsmConfig, u: torch.Tensor, spec=None):
    """Returns (y, state): the final SSD state and the conv's last
    CONV_K - 1 inputs (zeros in front of a shorter prompt)."""
    S = u.shape[1]
    lo = _ssm_tp(p, c, spec)
    y, s, x_raw = _ssd_chunked(lo.p, lo.c, lo.enter(u))
    if S < CONV_K - 1:
        tail = F.pad(x_raw, (0, 0, CONV_K - 1 - S, 0))
    else:
        tail = x_raw[:, S - (CONV_K - 1):]
    return lo.leave(y), lo.join({"s": s, "conv": tail})


def ssm_decode(p, c: SsmConfig, u: torch.Tensor, state, spec=None):
    """One recurrence step.  u: (B, 1, D).  Returns (y, new state)."""
    lo = _ssm_tp(p, c, spec)
    p, c, state = lo.p, lo.c, lo.cut(state)
    u = lo.enter(u)
    B_ = u.shape[0]
    H, P = c.n_heads, c.head_dim
    x_raw, z = dense(u, p["w_in"], mode=c.dense_mode).split(c.d_inner,
                                                            dim=-1)
    window = torch.cat([state["conv"], x_raw], dim=1)       # (B, K, Di)
    x = F.silu(torch.einsum("bkd,kd->bd", window, p["conv_w"])[:, None])
    Bm, Cm, dt, a = _gates(p, c, u)
    xh = x.reshape(B_, 1, H, P).float()
    contrib = torch.einsum("bsh,bshp,bsn->bhpn", dt, xh, Bm.float())
    s_new = state["s"] * a[:, 0, :, None, None] + contrib
    y = torch.einsum("bhpn,bn->bhp", s_new, Cm[:, 0].float())
    y = y + p["D"][None, :, None] * xh[:, 0]
    y = y.reshape(B_, 1, H * P).to(u.dtype) * F.silu(z)
    return (lo.leave(dense(y, p["w_out"], mode=c.dense_mode)),
            lo.join({"s": s_new, "conv": window[:, 1:]}))
