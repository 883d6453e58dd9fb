"""The yardstick's arithmetic: peaks of the card, the least time of one op
call (its roofline bound) and the model FLOPs of the work a run did.

Peaks are the NVIDIA H100 SXM5 data sheet's (dense, no sparsity, at the
700 W limit): 989e12 FLOP/s in bf16 on the tensor cores, 67e12 in f32 off
them, 3.35e12 bytes/s of HBM.  A frozen copy: the program's own roofline
module is not read, so a change to the program cannot move the yardstick.

A bound is max(FLOPs / peak, bytes / bandwidth) of one call, counted from
the call's own shapes and dtypes and from the work it has to do: every
input byte read once, every output byte written once, and only rows that
hold real work (a prefill chunk's real tokens, a decode step's active
lanes, the routed rows of an expert buffer), never padding; attention
counts only the positions each real query attends (capped by the window).
The count does not depend on which kernel serves the call, nor on how the
program pads it.
"""
from __future__ import annotations

from bench.reference.model import layer_kinds

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BW = 3.35e12


def peak_for(*itemsizes: int) -> float:
    """The tensor-core peak when every operand is 16-bit or narrower, else
    the f32 peak."""
    return PEAK_BF16 if max(itemsizes) <= 2 else PEAK_F32


def bound(flops: float, nbytes: float, peak: float) -> float:
    return max(flops / peak, nbytes / HBM_BW)


def dense_call(M: int, K: int, N: int, x_item: int, w_item: int,
               out_item: int, bias_item: int = 0) -> "tuple[float, float]":
    """(FLOPs, bytes) of y (M, N) = x (M, K) @ w (K, N) [+ bias (N,)]."""
    flops = 2.0 * M * K * N
    nbytes = M * K * x_item + K * N * w_item + M * N * out_item \
        + N * bias_item
    return flops, float(nbytes)


def grouped_call(E: int, R: int, D: int, F: int, x_item: int, w_item: int,
                 out_item: int) -> "tuple[float, float]":
    """(FLOPs, bytes) of R routed rows (R, D) @ (D, F) spread over E
    experts: each row read and written once, and the weights of the
    experts that can hold a row, min(E, R), read once."""
    flops = 2.0 * R * D * F
    nbytes = R * (D * x_item + F * out_item) + min(E, R) * D * F * w_item
    return flops, float(nbytes)


def attended(pos: int, window: "int | None") -> int:
    """Keys seen by a query at absolute position pos."""
    n = pos + 1
    return n if window is None else min(n, window)


def paged_attn_call(spans, H: int, dk: int, dv: int, kv_token_bytes: int,
                    window: "int | None", q_item: int,
                    out_item: int) -> "tuple[float, float]":
    """(FLOPs, bytes) of one paged attention call over the lanes that do
    work.  spans: (start, count) of each such lane's real queries, at
    absolute positions start, start + 1, ...; H heads of query width dk
    and value width dv; kv_token_bytes the bytes of one position of the
    pools it reads (keys and values, or latent and rope).  Each lane's
    attended positions are read once; each query computes scores and the
    weighted sum over its own attended positions."""
    flops = 0.0
    kv = queries = 0
    for p0, S in spans:
        flops += 2.0 * H * (dk + dv) * span_attended(p0, S, window)
        lo = 0 if window is None else max(0, p0 - window + 1)
        kv += (p0 + S - lo) * kv_token_bytes
        queries += S
    nbytes = queries * H * (dk * q_item + dv * out_item) + kv
    return flops, float(nbytes)


# ---------------------------------------------------------------------------
# model FLOPs (published form)
# ---------------------------------------------------------------------------

def _mlp(d: int, f: int) -> int:
    return 3 * d * f                       # SwiGLU: gate, up, down


def layer_params(cfg: dict, kind: str) -> int:
    """Weights one token uses in one layer (MoE: the top-k routed experts,
    the shared ones and the router)."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    if cfg.get("kv_lora_rank") is not None:
        r, rr = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
        nope, dv = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
        attn = d * H * (nope + rr) + d * (r + rr) + r * H * (nope + dv) \
            + H * dv * d
    else:
        hd = d // H
        kvh = cfg["num_key_value_heads"]
        attn = 2 * d * H * hd + 2 * d * kvh * hd
    if kind == "moe":
        f = cfg["moe_intermediate_size"]
        ffn = (cfg["num_experts_per_tok"] + cfg["n_shared_experts"]) \
            * _mlp(d, f) + d * cfg["n_routed_experts"]
    else:
        ffn = _mlp(d, cfg["intermediate_size"])
    return attn + ffn


def token_params(cfg: dict) -> int:
    """Non-embedding weights one token uses, the logits head included."""
    return sum(layer_params(cfg, k) for k in layer_kinds(cfg)) \
        + cfg["vocab_size"] * cfg["hidden_size"]


def attn_flops_per_position(cfg: dict) -> int:
    """Score and value FLOPs of one query against one key, all layers:
    2 x heads x (qk dim + v dim), published form."""
    H = cfg["num_attention_heads"]
    if cfg.get("kv_lora_rank") is not None:
        per = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] \
            + cfg["v_head_dim"]
    else:
        per = 2 * (cfg["hidden_size"] // H)
    return 2 * H * per * cfg["num_hidden_layers"]


def span_attended(start: int, count: int, window: "int | None") -> int:
    """Sum of attended(p) for p in [start, start + count)."""
    if count <= 0:
        return 0
    end = start + count                      # exclusive
    if window is None or end <= window:
        return (start + 1 + end) * count // 2
    lo_part = max(0, min(end, window) - start)
    s = (start + 1 + start + lo_part) * lo_part // 2 if lo_part > 0 else 0
    return s + (count - lo_part) * window


def serve_flops_spans(cfg: dict, spans) -> float:
    """Forward FLOPs of tokens at spans (start, count) of consecutive
    positions: 2 x the weights a token uses, plus attention over each
    token's attended positions."""
    w = cfg.get("sliding_window")
    n = sum(c for _, c in spans)
    att = sum(span_attended(s, c, w) for s, c in spans)
    return 2.0 * token_params(cfg) * n + attn_flops_per_position(cfg) * att


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    """One training step: 6 x the weights a token uses x tokens, plus
    attention's forward and backward (3 x the forward) over the causal
    positions; recomputation is not counted."""
    w = cfg.get("sliding_window")
    att = span_attended(0, seq, w) * batch
    return 6.0 * token_params(cfg) * batch * seq \
        + 3.0 * attn_flops_per_position(cfg) * att
