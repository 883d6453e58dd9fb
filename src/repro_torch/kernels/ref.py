"""Plain PyTorch versions of the CUDA kernels, and the chunk-schedule
oracle.

`dense_ref`, `dense_grouped_ref` and `paged_attn_ref` (GQA, window and MLA)
are copies of `repro.kernels.ref` in torch:
the CPU path of the port runs them, and `chip_smoke.py` holds each kernel
against them on the card.  `dense_split_ref` replays the tensor-core
`gpp_matmul`'s stream-K split and its fixed-order fix-up for the tests.  `mla_merge_ref` is the plain version of the
bf16 MLA kernel's merge; `paged_attn_mla_split_ref` replays that kernel's
split-KV walk and merge for the tests (nothing on the main path calls
either).  `chunk_issue_schedule` is a copy of the
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


def dense_split_ref(x: torch.Tensor, w: torch.Tensor, plan, *, bias=None,
                    w_scale=None,
                    activation: "str | None" = None) -> torch.Tensor:
    """Plain replay of `gpp_matmul`'s tensor-core route (stream-K), for
    tests: for each (block_m x block_n) tile of `plan`
    (`core.schedule.plan_matmul_tc_sm90`), each CTA that shares it
    (`plan.segments(t)`) computes an f32 partial over its run's k-steps of
    the tile; the partials are summed in segment order, then the epilogue
    runs as in `dense_ref` (f32 scale, bias, activation), cast to
    x.dtype."""
    M, K = x.shape
    N = w.shape[1]
    bm, bn, bk = plan.block_m, plan.block_n, plan.block_k
    acc = torch.zeros(M, N, dtype=torch.float32, device=x.device)
    for t in range(plan.tiles):
        nt, mt = plan.tile(t)
        rows = slice(mt * bm, min(M, (mt + 1) * bm))
        cols = slice(nt * bn, min(N, (nt + 1) * bn))
        total = None
        for i in plan.segments(t):
            ks = [plan.unit(u)[1] for u in plan.cta_units(i)
                  if plan.unit(u)[0] == t]
            k0, k1 = ks[0] * bk, min(K, (ks[-1] + 1) * bk)
            part = x[rows, k0:k1].float() @ w[k0:k1, cols].float()
            total = part if total is None else total + part
        acc[rows, cols] = total
    if w_scale is not None:
        acc = acc * torch.as_tensor(w_scale, dtype=torch.float32,
                                    device=acc.device).reshape(1, -1)
    if bias is not None:
        acc = acc + bias.float().reshape(1, -1)
    return ACTIVATIONS[activation](acc).to(x.dtype)


def dense_grouped_ref(x: torch.Tensor, w: torch.Tensor, *, bias=None,
                      w_scale=None,
                      activation: "str | None" = None) -> torch.Tensor:
    """Plain version of `gpp_matmul_grouped`'s fused epilogue: per expert
    y[e] = act(x[e] @ w[e] [* w_scale[e]] [+ bias[e]]) with f32
    accumulation, the dequant scale (scalar, (E,) or (E, N)) applied after
    accumulation, cast to x.dtype."""
    E = x.shape[0]
    acc = torch.bmm(x.float(), w.float())
    if w_scale is not None:
        sc = torch.as_tensor(w_scale, dtype=torch.float32, device=acc.device)
        acc = acc * (sc if sc.dim() == 0 else sc.reshape(E, 1, -1))
    if bias is not None:
        acc = acc + bias.float()[:, None, :]
    return ACTIVATIONS[activation](acc).to(x.dtype)


def paged_attn_ref(q, pool_a, pool_b, tables, positions, *, num_kv_heads,
                   scale, window=None, mla: bool = False) -> torch.Tensor:
    """Plain version of the paged-attention kernel: gather the pools
    through the block tables into each lane's (MB*bs, ...) sequence, then
    the reference's `_sdpa` math over a dense position mask (same casts,
    f32 accumulation, -1e30 masking).

    q: (B, S, H, dk); tables: (B, MB) int32; positions: (B,) int32 per-lane
    start positions.  GQA: pools k / v (nb, bs, KVH, hd).  MLA (`mla`):
    pools c_kv (nb, bs, kv_lora) / k_rope (nb, bs, rope), q absorbed
    (dk = kv_lora + rope), one shared KV head whose key is
    concat(c_kv, k_rope) and whose value is c_kv.  Returns (B, S, H, dv) in
    q.dtype (dv = hd, or kv_lora under `mla`).
    """
    B, S, H, dk = q.shape
    t = tables.long()

    def gather(pool):
        return pool[t].reshape(B, -1, *pool.shape[2:])

    if mla:
        kseq = torch.cat([gather(pool_a), gather(pool_b)], dim=-1)[:, :, None]
        vseq = gather(pool_a)[:, :, None]
        kvh = 1
    else:
        kvh = num_kv_heads
        kseq = gather(pool_a)                              # (B, T, KVH, hd)
        vseq = gather(pool_b)
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


def mla_merge_ref(ws: torch.Tensor, *, batch: int, row_tiles: int,
                  kv_splits: int, latent: int, rows: int) -> torch.Tensor:
    """Plain version of `paged_attention_mla_merge_kernel`: merge the split
    partials in the tensor-core MLA kernel's workspace — per (lane, 16-row
    tile) unit and split, 16 rows of f32 acc (latent wide), then the (m, l)
    pairs — as m = max m_i, w_i = exp(m_i - m) (0 for an empty run, whose
    acc is never read), out = sum w_i acc_i / max(sum w_i l_i, 1e-30).
    Returns (batch, rows, latent) in f32 (the kernel rounds it to
    bf16)."""
    units = batch * row_tiles
    n_acc = units * kv_splits * 16 * latent
    acc = ws[:n_acc].view(units, kv_splits, 16, latent)
    ml = ws[n_acc:n_acc + units * kv_splits * 32].view(units, kv_splits,
                                                        16, 2)
    m, l = ml[..., 0], ml[..., 1]
    top = m.max(dim=1, keepdim=True).values
    w = torch.where(torch.isinf(m), 0.0, torch.exp(m - top))
    live = (w != 0)[..., None]
    tot = (torch.where(live, acc, 0.0) * w[..., None]).sum(dim=1)
    out = tot / torch.clamp((w * l).sum(dim=1), min=1e-30)[..., None]
    return out.reshape(batch, row_tiles * 16, latent)[:, :rows]


def paged_attn_mla_split_ref(q, c_kv, k_rope, tables, positions, *,
                             scale: float, kv_splits: int,
                             window=None) -> torch.Tensor:
    """Plain replay of the tensor-core MLA kernel's split-KV walk and merge
    (csrc/paged_attention.cu), for tests.

    Each lane's logical blocks are cut into the planner's runs
    (`core.schedule.kv_runs`); each run walks its live blocks with the TPU
    kernel's online-softmax step (f32 m / l / acc, masked logits -inf, p
    cast to the KV dtype before p . c_kv) and leaves its partial (m, l,
    acc) in the kernel's workspace layout; with more than one run the
    partials merge as `mla_merge_ref` does, else the run's acc / max(l,
    1e-30) is the output.
    Shapes as `paged_attn_ref(mla=True)`; the result is in q.dtype."""
    from repro_torch.core.schedule import kv_runs
    B, S, H, dk = q.shape
    kd = c_kv.dtype
    bs, MB = c_kv.shape[1], tables.shape[1]
    da = c_kv.shape[2]
    rows = H * S
    rt = -(-rows // 16)
    neg = float("-inf")
    qr = (q.float() * scale).to(kd).float().permute(0, 2, 1, 3) \
        .reshape(B, rows, dk)                      # rows h * S + s
    rq = torch.arange(rows) % S
    acc_ws = torch.zeros(B, rt * 16, kv_splits, da)
    ml_ws = torch.zeros(B, rt * 16, kv_splits, 2)
    for b in range(B):
        pos = int(positions[b])
        for i, run in enumerate(kv_runs(MB, kv_splits)):
            m = torch.full((rows,), neg)
            l = torch.zeros(rows)
            acc = torch.zeros(rows, da)
            for j in run:
                if j * bs > pos + S - 1 or (
                        window and (j + 1) * bs - 1 <= pos - window):
                    continue                        # dead: neither read
                phys = int(tables[b, j])
                ckv = c_kv[phys].float()
                key = torch.cat([ckv, k_rope[phys].float()], dim=-1)
                logits = qr[b] @ key.T
                kpos = j * bs + torch.arange(bs)
                valid = kpos[None, :] <= pos + rq[:, None]
                if window:
                    valid &= kpos[None, :] > pos + rq[:, None] - window
                logits = logits.masked_fill(~valid, neg)
                m_new = torch.maximum(m, logits.max(dim=-1).values)
                m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
                p = torch.exp(logits - m_safe[:, None])
                corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
                l = l * corr + p.sum(dim=-1)
                acc = acc * corr[:, None] + p.to(kd).float() @ ckv
                m = m_new
            acc_ws[b, :rows, i] = acc
            ml_ws[b, :rows, i, 0] = m
            ml_ws[b, :rows, i, 1] = l
    if kv_splits == 1:
        out = acc_ws[:, :rows, 0] / torch.clamp(ml_ws[:, :rows, 0, 1:],
                                                min=1e-30)
    else:   # the kernel's layout: (unit, split, row, ...)
        ws = torch.cat([
            acc_ws.reshape(B, rt, 16, kv_splits, da).transpose(2, 3)
            .reshape(-1),
            ml_ws.reshape(B, rt, 16, kv_splits, 2).transpose(2, 3)
            .reshape(-1)])
        out = mla_merge_ref(ws, batch=B, row_tiles=rt, kv_splits=kv_splits,
                            latent=da, rows=rows)
    return (out.reshape(B, H, S, da).permute(0, 2, 1, 3)
            .to(q.dtype))


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
