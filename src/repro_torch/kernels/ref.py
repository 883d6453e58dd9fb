"""Plain PyTorch versions of the two CUDA kernels, and the chunk-schedule
oracle.

`dense_ref` and `paged_attn_ref` are copies of `repro.kernels.ref` in torch:
the CPU path of the port runs them, and `chip_smoke.py` holds each kernel
against them on the card.  `chunk_issue_schedule` is a copy of the
reference's pure-Python replay of the generalized ping-pong issue order
(`repro/kernels/gpp_matmul.py:78`); the CUDA ring (`csrc/ring.cuh`) issues
chunks in exactly this order, which the kernel's issue-order record shows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation (not torch's erf form)
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    None: lambda x: x,
    "none": lambda x: x,
    "relu": torch.relu,
    "gelu": _gelu_tanh,
    "silu": F.silu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
}

# activation ids shared with csrc/gpp_matmul.cu
ACTIVATION_IDS = {None: 0, "none": 0, "relu": 1, "gelu": 2, "silu": 3,
                  "tanh": 4, "sigmoid": 5}


def dense_ref(x: torch.Tensor, w: torch.Tensor, *, bias=None, w_scale=None,
              activation: "str | None" = None) -> torch.Tensor:
    """Plain version of `gpp_matmul`'s fused epilogue: f32 accumulation,
    then per-column dequant scale, bias and activation, all in f32, cast to
    x.dtype."""
    acc = x.float() @ w.float()
    if w_scale is not None:
        acc = acc * torch.as_tensor(w_scale, dtype=torch.float32,
                                    device=acc.device).reshape(1, -1)
    if bias is not None:
        acc = acc + bias.float().reshape(1, -1)
    return ACTIVATIONS[activation](acc).to(x.dtype)


def paged_attn_ref(q, pool_a, pool_b, tables, positions, *, num_kv_heads,
                   scale, window=None) -> torch.Tensor:
    """Plain version of the paged-attention kernel: gather the pools
    through the block tables into each lane's (MB*bs, ...) sequence, then
    the reference's `_sdpa` math over a dense position mask (same casts,
    f32 accumulation, -1e30 masking).

    q: (B, S, H, hd); pools: (nb, bs, KVH, hd); tables: (B, MB) int32;
    positions: (B,) int32 per-lane start positions.  Returns (B, S, H, hd)
    in q.dtype.
    """
    B, S, H, dk = q.shape
    kvh = num_kv_heads
    t = tables.long()
    kseq = pool_a[t].reshape(B, -1, *pool_a.shape[2:])     # (B, T, KVH, hd)
    vseq = pool_b[t].reshape(B, -1, *pool_b.shape[2:])
    T = kseq.shape[1]
    dev = q.device
    qpos = (positions.long()[:, None, None]
            + torch.arange(S, device=dev)[None, :, None])
    kpos = torch.arange(T, device=dev)[None, None, :]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    rep = H // kvh
    qr = (q.float() * scale).to(kseq.dtype).reshape(B, S, kvh, rep, dk)
    logits = torch.einsum("bsgrh,btgh->bgrst", qr.float(), kseq.float())
    logits = logits.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrst,btgh->bsgrh", probs.to(vseq.dtype).float(),
                       vseq.float())
    return out.reshape(B, S, H, vseq.shape[-1]).to(q.dtype)


def chunk_issue_schedule(num_steps: int, G: int,
                         C: int) -> "dict[tuple[int, int], list[int]]":
    """Pure-Python replay of the ring's issue schedule.

    Returns {(step, chunk): [issue_steps]} — the steps at which chunk
    `chunk` of the tile consumed at `step` is issued.  G == 1 is in-situ;
    otherwise chunk c of step s is issued at step s-C+c, steps < 0 folding
    into the step-0 prologue.
    """
    issued: "dict[tuple[int, int], list[int]]" = {}
    for s in range(num_steps):
        if G == 1:
            issued.setdefault((s, 0), []).append(s)
            continue
        if s == 0:
            for c in range(C):                       # step 0: all chunks now
                issued.setdefault((0, c), []).append(0)
            for d in range(1, C):                    # ramp: folded chunks
                if d < num_steps:
                    for c in range(0, C - d):
                        issued.setdefault((d, c), []).append(0)
        for d in range(1, G):                        # steady state
            c = C - d
            if c >= 0 and s + d < num_steps:
                issued.setdefault((s + d, c), []).append(s)
    return issued
