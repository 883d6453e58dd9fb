"""Plain PyTorch versions of the CUDA kernels, and the chunk-schedule
oracle.

`dense_ref`, `dense_grouped_ref` and `paged_attn_ref` (GQA, window and MLA)
are copies of `repro.kernels.ref` in torch, and `rmsnorm_ref` of
`repro.models.layers.rmsnorm` (written as its steps: a sum, / d):
the CPU path of the port runs them, and `chip_smoke.py` holds each kernel
against them on the card.  `dense_split_ref` and `dense_grouped_split_ref`
replay the split-K of the FMA route of `gpp_matmul` and
`gpp_matmul_grouped` and its fixed-order fix-up, `dense_cluster_ref`
the cluster split-K of its tensor-core route and its rank-order sum, for
the tests.
`mla_merge_ref` is the plain version of the merge kernel that the split
attention kernels share; `paged_attn_fma_split_ref` replays their split-KV
walks and merge (`paged_attn_mla_split_ref` and `paged_attn_gqa_split_ref`
at the tensor-core kernels' whole blocks) for the tests and
`chip_smoke.py` (nothing on the main path calls them).
`chunk_issue_schedule` is a copy of the
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


def _epilogue(acc: torch.Tensor, dtype, w_scale, bias,
              activation: "str | None") -> torch.Tensor:
    """`dense_ref`'s epilogue on an f32 accumulator: per-column scale,
    bias, activation, all in f32, cast to `dtype`."""
    if w_scale is not None:
        acc = acc * torch.as_tensor(w_scale, dtype=torch.float32,
                                    device=acc.device).reshape(1, -1)
    if bias is not None:
        acc = acc + bias.float().reshape(1, -1)
    return ACTIVATIONS[activation](acc).to(dtype)


def dense_ref(x: torch.Tensor, w: torch.Tensor, *, bias=None, w_scale=None,
              activation: "str | None" = None) -> torch.Tensor:
    """Plain version of `gpp_matmul`'s fused epilogue: f32 accumulation,
    then per-column dequant scale, bias and activation, all in f32, cast to
    x.dtype."""
    return _epilogue(x.float() @ w.float(), x.dtype, w_scale, bias,
                     activation)


def _split_acc(x: torch.Tensor, w: torch.Tensor, plan) -> torch.Tensor:
    """The f32 accumulator (E, M, N) of the FMA route's split-K walk over
    (E, M, K) @ (E, K, N): for each tile of `plan` (block_m x block_n of
    expert `plan.expert(t)`), each CTA that shares it (`plan.segments(t)`)
    computes an f32 partial over its run's k-steps of the tile, and the
    partials are summed in segment order.  Each row is computed by itself
    (a vector-matrix product of fixed shape a segment), so a row's bits
    depend on the row and the plan's k-cuts alone, as the kernel's do."""
    E, M, K = x.shape
    N = w.shape[2]
    bm, bn, bk = plan.block_m, plan.block_n, plan.block_k
    acc = torch.zeros(E, M, N, dtype=torch.float32, device=x.device)
    for t in range(plan.tiles):
        nt, mt = plan.tile(t)
        e = plan.expert(t)
        rows = slice(mt * bm, min(M, (mt + 1) * bm))
        cols = slice(nt * bn, min(N, (nt + 1) * bn))
        total = None
        for i in plan.segments(t):
            ks = [plan.unit(u)[1] for u in plan.cta_units(i)
                  if plan.unit(u)[0] == t]
            k0, k1 = ks[0] * bk, min(K, (ks[-1] + 1) * bk)
            wk = w[e, k0:k1, cols].float()
            part = torch.stack([r @ wk for r in x[e, rows, k0:k1].float()])
            total = part if total is None else total + part
        acc[e, rows, cols] = total
    return acc


def dense_split_ref(x: torch.Tensor, w: torch.Tensor, plan, *, bias=None,
                    w_scale=None,
                    activation: "str | None" = None) -> torch.Tensor:
    """Plain replay of the split-K of `gpp_matmul`'s FMA route, for tests:
    `_split_acc` over `plan` (`core.schedule.plan_matmul_fma_sm90`), then
    the epilogue as in `dense_ref` (f32 scale, bias, activation), cast to
    x.dtype."""
    return _epilogue(_split_acc(x[None], w[None], plan)[0], x.dtype,
                     w_scale, bias, activation)


def dense_grouped_split_ref(x: torch.Tensor, w: torch.Tensor, plan, *,
                            bias=None, w_scale=None,
                            activation: "str | None" = None) -> torch.Tensor:
    """Plain replay of the split-K of `gpp_matmul_grouped`'s FMA route over
    its expert axis, for tests: `_split_acc` over `plan`
    (`plan_matmul_fma_sm90(..., E=E)`: runs cross expert boundaries), then
    the epilogue as in `dense_grouped_ref`, cast to x.dtype."""
    return _grouped_epilogue(_split_acc(x, w, plan), x.dtype, w_scale, bias,
                             activation)


def dense_cluster_ref(x: torch.Tensor, w: torch.Tensor, plan, *,
                      bias=None, w_scale=None,
                      activation: "str | None" = None) -> torch.Tensor:
    """Plain replay of the cluster split-K of `gpp_matmul`'s tensor-core
    route, for tests: for each block_n-column tile of `plan`
    (`core.schedule.plan_matmul_tc_sm90`), rank r of its cluster computes
    one f32 partial a k-group over the k rows that group multiplies in
    slice r (`plan.k_rows(r, g)`); the partials are summed from 0.0 in
    rank order, each rank's k-groups in order, then the epilogue runs as
    in `dense_ref`, cast to x.dtype.  Rows do not interact, so the m-tiles
    need no loop of their own."""
    N = w.shape[1]
    bn = plan.block_n
    acc = torch.zeros(x.shape[0], N, dtype=torch.float32, device=x.device)
    for nt in range(plan.n_tiles):
        cols = slice(nt * bn, min(N, (nt + 1) * bn))
        for r in range(plan.cluster):
            for g in range(plan.k_groups):
                ks = torch.tensor(plan.k_rows(r, g), dtype=torch.long)
                acc[:, cols] += x[:, ks].float() @ w[ks, cols].float()
    return _epilogue(acc, x.dtype, w_scale, bias, activation)


def _grouped_epilogue(acc: torch.Tensor, dtype, w_scale, bias,
                      activation: "str | None") -> torch.Tensor:
    """`dense_grouped_ref`'s epilogue on an f32 (E, M, N) accumulator:
    scale (scalar, (E,) or (E, N)), bias (E, N), activation, all in f32,
    cast to `dtype`."""
    E = acc.shape[0]
    if w_scale is not None:
        sc = torch.as_tensor(w_scale, dtype=torch.float32, device=acc.device)
        acc = acc * (sc if sc.dim() == 0 else sc.reshape(E, 1, -1))
    if bias is not None:
        acc = acc + bias.float()[:, None, :]
    return ACTIVATIONS[activation](acc).to(dtype)


# f32 elements of W widened at once by `dense_grouped_ref` (256 MB): an
# expert stack is taken a chunk of experts at a time, so no f32 copy of a
# whole stack exists (kimi-k2's 384 x 7168 x 2048 would be 22.5 GB)
GROUPED_REF_CHUNK_ELEMS = 1 << 26


def grouped_ref_chunk(E: int, K: int, N: int) -> int:
    """Experts `dense_grouped_ref` widens and multiplies at once."""
    return max(1, min(E, GROUPED_REF_CHUNK_ELEMS // max(1, K * N)))


def dense_grouped_ref(x: torch.Tensor, w: torch.Tensor, *, bias=None,
                      w_scale=None,
                      activation: "str | None" = None) -> torch.Tensor:
    """Plain version of `gpp_matmul_grouped`'s fused epilogue: per expert
    y[e] = act(x[e] @ w[e] [* w_scale[e]] [+ bias[e]]) with f32
    accumulation, the dequant scale (scalar, (E,) or (E, N)) applied after
    accumulation, cast to x.dtype.  Computed over chunks of experts
    (`grouped_ref_chunk`); each expert's product and epilogue are its own,
    so the result is the whole stack's."""
    E, M, _ = x.shape
    K, N = w.shape[1:]
    sc = None if w_scale is None else torch.as_tensor(
        w_scale, dtype=torch.float32, device=x.device)
    y = torch.empty(E, M, N, dtype=x.dtype, device=x.device)
    step = grouped_ref_chunk(E, K, N)
    for e0 in range(0, E, step):
        e = slice(e0, e0 + step)
        y[e] = _grouped_epilogue(
            torch.bmm(x[e].float(), w[e].float()), x.dtype,
            sc if sc is None or sc.dim() == 0 else sc[e],
            None if bias is None else bias[e], activation)
    return y


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


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Plain version of `rmsnorm_kernel` (and of the reference's RMSNorm):
    in f32, r = rsqrt(sum(x * x) / d + eps) over the last dim, then
    (x * r) * scale, cast to x.dtype.  The sum's order is PyTorch's, which
    may depend on the tensor's shape; the kernel's does not."""
    xf = x.float()
    ss = torch.sum(xf * xf, dim=-1, keepdim=True)
    r = torch.rsqrt(ss / x.shape[-1] + eps)
    return (xf * r * scale.float()).to(x.dtype)


def mla_merge_ref(ws: torch.Tensor, *, batch: int, row_tiles: int,
                  kv_splits: int, latent: int, rows: int,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of `paged_attention_merge_kernel`: merge the split
    partials in a split attention kernel's workspace — per unit ((lane,
    16-row tile) for MLA, (lane, KV head, tile) for GQA: `batch` counts
    lanes, or lanes x KV heads) and split, 16 rows of f32 acc (`latent`
    wide: the latent, or the head_dim), then the (m, l) pairs — as m = max
    m_i, w_i = exp(m_i - m) (0 for an empty run, whose acc is never read),
    out = sum w_i acc_i / max(sum w_i l_i, 1e-30) in f32.  Returns (batch,
    rows, latent) in `dtype` (the kernel's output dtype: f32, or bf16 for
    the tensor-core kernels and the FMA kernels' bf16 instances)."""
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
    return out.reshape(batch, row_tiles * 16, latent)[:, :rows].to(dtype)


def paged_attn_fma_split_ref(q, pool_a, pool_b, tables, positions, *,
                             num_kv_heads: int, scale: float,
                             kv_splits: int, piece: int, window=None,
                             mla: bool = False) -> torch.Tensor:
    """Plain replay of a split paged-attention kernel's walk and merge
    (csrc/paged_attention.cu), for tests: the FMA kernels' (pieces of
    `piece` tokens) and, with piece = block size, the tensor-core kernels'
    (whole blocks).

    A lane's keys [0, MB * bs) are cut into pieces of `piece` tokens and
    the pieces into the planner's runs (`core.schedule.kv_runs`).  Each
    (lane, KV head)'s rows (rep x S, head-major: row = r * S + s; MLA: 16
    heads x S, one shared head) walk each run alone: the run's live
    pieces (the kernels' predicate: a key at or before the lane's last
    query position and, with a window, one not yet expired for its first)
    get the TPU kernel's online-softmax step (f32 m / l / acc, logits -inf
    where masked, p rounded through the KV dtype against the run's own
    max before p . v) and leave a partial (m, l, acc) in the kernels'
    workspace layout; with more than one run the partials merge as
    `mla_merge_ref` does, else acc / max(l, 1e-30) is the output.  MLA:
    the key is concat(c_kv, k_rope) and the value the c_kv row.  Each row
    is computed by itself (one matrix-vector product of fixed shape a
    piece), so a row's bits depend on the row alone, as the kernels' do.
    Shapes as `paged_attn_ref`; the result is in q.dtype."""
    from repro_torch.core.schedule import kv_runs
    B, S, H, dk = q.shape
    kvh = 1 if mla else num_kv_heads
    rep = H // kvh
    kd = pool_a.dtype
    bs, MB = pool_a.shape[1], tables.shape[1]
    dv = pool_a.shape[-1]
    ppb = bs // piece
    rows = rep * S
    rt = -(-rows // 16)
    neg = float("-inf")
    dev = q.device
    qr = ((q.float() * scale).to(kd).float().reshape(B, S, kvh, rep, dk)
          .permute(0, 2, 3, 1, 4).reshape(B, kvh, rows, dk))
    acc_ws = torch.zeros(B, kvh, rt * 16, kv_splits, dv, device=dev)
    ml_ws = torch.zeros(B, kvh, rt * 16, kv_splits, 2, device=dev)
    for b in range(B):
        pos = int(positions[b])
        for i, run in enumerate(kv_runs(MB * ppb, kv_splits)):
            live = [j for j in run if j * piece <= pos + S - 1 and not (
                window and (j + 1) * piece - 1 <= pos - window)]
            for g in range(kvh):
                kv = []
                for j in live:
                    blk = int(tables[b, j // ppb])
                    t = slice((j % ppb) * piece, (j % ppb + 1) * piece)
                    if mla:
                        val = pool_a[blk, t].float()
                        key = torch.cat([val, pool_b[blk, t].float()], -1)
                    else:
                        key = pool_a[blk, t, g].float()
                        val = pool_b[blk, t, g].float()
                    kv.append((j * piece + torch.arange(piece, device=dev),
                               key, val))
                for r in range(rows):
                    qpos = pos + r % S
                    m = torch.tensor(neg, device=dev)
                    l = torch.tensor(0.0, device=dev)
                    acc = torch.zeros(dv, device=dev)
                    for kpos, key, val in kv:
                        logits = torch.mv(key, qr[b, g, r])
                        valid = kpos <= qpos
                        if window:
                            valid &= kpos > qpos - window
                        logits = logits.masked_fill(~valid, neg)
                        m_new = torch.maximum(m, logits.max())
                        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
                        p = torch.exp(logits - m_safe)
                        corr = torch.where(torch.isinf(m), 0.0,
                                           torch.exp(m - m_safe))
                        l = l * corr + p.sum()
                        acc = acc * corr + torch.mv(val.t(),
                                                    p.to(kd).float())
                        m = m_new
                    acc_ws[b, g, r, i] = acc
                    ml_ws[b, g, r, i, 0] = m
                    ml_ws[b, g, r, i, 1] = l
    if kv_splits == 1:
        out = acc_ws[:, :, :rows, 0] / torch.clamp(
            ml_ws[:, :, :rows, 0, 1:], min=1e-30)
    else:   # the kernels' layout: (unit, split, row, ...)
        ws = torch.cat([
            acc_ws.reshape(B * kvh, rt, 16, kv_splits, dv).transpose(2, 3)
            .reshape(-1),
            ml_ws.reshape(B * kvh, rt, 16, kv_splits, 2).transpose(2, 3)
            .reshape(-1)])
        out = mla_merge_ref(ws, batch=B * kvh, row_tiles=rt,
                            kv_splits=kv_splits, latent=dv, rows=rows)
    return (out.reshape(B, kvh, rep, S, dv).permute(0, 3, 1, 2, 4)
            .reshape(B, S, H, dv).to(q.dtype))


def paged_attn_mla_split_ref(q, c_kv, k_rope, tables, positions, *,
                             scale: float, kv_splits: int,
                             window=None) -> torch.Tensor:
    """Plain replay of the tensor-core MLA kernel's split-KV walk over
    runs of whole blocks and its merge: `paged_attn_fma_split_ref` with
    the piece the block.  Shapes as `paged_attn_ref(mla=True)`."""
    return paged_attn_fma_split_ref(
        q, c_kv, k_rope, tables, positions, num_kv_heads=1, scale=scale,
        kv_splits=kv_splits, piece=c_kv.shape[1], window=window, mla=True)


def paged_attn_gqa_split_ref(q, k, v, tables, positions, *,
                             num_kv_heads: int, scale: float,
                             kv_splits: int, window=None) -> torch.Tensor:
    """Plain replay of the tensor-core GQA / window kernel's split-KV walk
    over runs of whole blocks and its merge: `paged_attn_fma_split_ref`
    with the piece the block.  Shapes as `paged_attn_ref`."""
    return paged_attn_fma_split_ref(
        q, k, v, tables, positions, num_kv_heads=num_kv_heads, scale=scale,
        kv_splits=kv_splits, piece=k.shape[1], window=window)


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
