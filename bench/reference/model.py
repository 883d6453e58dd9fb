"""Plain float32 PyTorch forward of the benchmark's decoder configurations.

The yardstick that decides `correct`: it reads a configuration as the
benchmark's JSON file states it (the published `config.json` keys) and a
parameter tree the benchmark made from the seed, and computes the logits of
whole token sequences with no cache, no paging, no batching across requests
and no kernel.  It imports torch and the standard library only.

Layer equations (each departure from the published model is named in the
configuration file's `reduced` and in PERF.md):

* RMSNorm: x * rsqrt(mean(x^2) + eps) * w, in f32.
* RoPE: the split-half form (GPT-NeoX / Llama) at `rope_theta`, no scaling.
  DeepSeek's checkpoint stores its rope columns interleaved; with weights
  drawn at random the two layouts are the same model up to a fixed
  permutation of those columns.
* GQA (`num_key_value_heads` < heads), optional `sliding_window`: query i
  sees keys j with i - window < j <= i; scale 1 / sqrt(head_dim).
* MLA (`kv_lora_rank`): q = x W_q (no q compression), [c_kv, k_rope] =
  x W_dkv, c_kv RMS-normed, k = [c_kv W_uk, rope(k_rope)], v = c_kv W_uv,
  scale 1 / sqrt(qk_nope_head_dim + qk_rope_head_dim), the output through
  W_o.  The published up-projected form, not the absorbed one.
* MoE: softmax router in f32, top-k, weights renormalised when
  `norm_topk_prob`, every routed token computed (no capacity, no drop),
  plus the shared experts as one SwiGLU MLP of n_shared x moe width.
* SwiGLU MLPs, a final RMSNorm and an untied f32 logits head.

`quant="fp8"` computes every weight product with both operands rounded to
float8 e4m3 (activations scaled per row, weights per tensor): the control,
the precision below the configuration's bfloat16.

Parameters are read in the tree layout the benchmark hands to both sides:
`embed.embedding`, `prefix` (a list of leading layers), `blocks.b0` (the
repeated layer, its leaves stacked on a leading dim), `final_norm.scale`,
`lm_head.w_out`.
"""
from __future__ import annotations

import math

import torch

Q_CHUNK = 1024          # query rows of one attention block


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def _q8(t: torch.Tensor, dim) -> torch.Tensor:
    """t rounded to float8 e4m3 under a scale that maps its largest
    magnitude (over `dim`, or the whole tensor for None) to 448."""
    a = t.abs().amax() if dim is None else t.abs().amax(dim=dim, keepdim=True)
    s = torch.clamp(a, min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Precision:
    """f32 everywhere, or (`quant="fp8"`) every weight product in e4m3."""

    def __init__(self, quant: "str | None" = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.quant = quant

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = _f32(w)
        return _q8(w, None) if self.quant else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _q8(x, -1) if self.quant else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., K) @ w (K, N), w already through `weight`."""
        return self.act(x) @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * _f32(w)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, ..., hd) rotated at positions pos (T,), split-half layout."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = pos.to(torch.float64)[:, None] * freqs[None]
    shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (half,)
    cos = torch.cos(ang).to(torch.float32).reshape(shape)
    sin = torch.sin(ang).to(torch.float32).reshape(shape)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attend(q, k, v, scale: float, window: "int | None") -> torch.Tensor:
    """Causal attention of one sequence: q (T, H, dk), k (T, KVH, dk),
    v (T, KVH, dv) -> (T, H, dv), query rows in blocks."""
    T, H, _ = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)     # (H, T, dk)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)     # (H, T, dv)
    kpos = torch.arange(T, device=q.device)
    out = []
    for s in range(0, T, Q_CHUNK):
        e = min(T, s + Q_CHUNK)
        qpos = torch.arange(s, e, device=q.device)[:, None]
        mask = kpos[None] <= qpos
        if window is not None:
            mask &= kpos[None] > qpos - window
        lo = 0 if window is None else max(0, s - window + 1)
        sc = torch.einsum("shd,htd->hst", q[s:e], k[:, lo:e]) * scale
        sc = sc.masked_fill(~mask[None, :, lo:e], float("-inf"))
        p = torch.softmax(sc, dim=-1)
        out.append(torch.einsum("hst,htd->shd", p, v[:, lo:e]))
    return torch.cat(out, dim=0)


class Layer:
    """One decoder layer's f32 weights (through the precision), taken from
    the tree once and applied to every sequence."""

    def __init__(self, cfg: dict, p: dict, kind: str, prec: Precision):
        self.cfg, self.kind, self.prec = cfg, kind, prec
        w = prec.weight
        self.ln1 = _f32(p["ln1"]["scale"])
        self.ln2 = _f32(p["ln2"]["scale"])
        a = p["attn"]
        self.mla = cfg.get("kv_lora_rank") is not None
        if self.mla:
            self.w_q = w(a["w_q"].reshape(a["w_q"].shape[0], -1))
            self.w_dkv = w(a["w_dkv"])
            r = a["w_uk"].shape[0]
            self.w_uk = w(a["w_uk"].reshape(r, -1))
            self.w_uv = w(a["w_uv"].reshape(r, -1))
            self.kv_norm = _f32(a["kv_norm"])
        else:
            d = a["w_q"].shape[0]
            self.w_q = w(a["w_q"].reshape(d, -1))
            self.w_k = w(a["w_k"].reshape(d, -1))
            self.w_v = w(a["w_v"].reshape(d, -1))
        self.w_o = w(a["w_o"].reshape(-1, a["w_o"].shape[-1]))
        if kind == "moe":
            m = p["moe"]
            self.router = w(m["router"])
            self.experts = [(w(m["w_gate"][e]), w(m["w_up"][e]),
                             w(m["w_down"][e]))
                            for e in range(m["w_gate"].shape[0])]
            s = m["shared"]
            self.mlp = (w(s["w_gate"]), w(s["w_up"]), w(s["w_down"]))
        else:
            m = p["mlp"]
            self.mlp = (w(m["w_gate"]), w(m["w_up"]), w(m["w_down"]))

    def _swiglu(self, x, ws):
        g, u, d = ws
        mm = self.prec.mm
        return mm(torch.nn.functional.silu(mm(x, g)) * mm(x, u), d)

    def _attention(self, h: torch.Tensor) -> torch.Tensor:
        c, mm = self.cfg, self.prec.mm
        T = h.shape[0]
        pos = torch.arange(T, device=h.device)
        H = c["num_attention_heads"]
        theta = float(c["rope_theta"])
        if self.mla:
            nope, rr = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
            r = c["kv_lora_rank"]
            q = mm(h, self.w_q).reshape(T, H, nope + rr)
            q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, theta)],
                          dim=-1)
            dkv = mm(h, self.w_dkv)
            ckv = rmsnorm(dkv[:, :r], self.kv_norm, c["rms_norm_eps"])
            kr = rope(dkv[:, r:][:, None, :], pos, theta)
            k = torch.cat([mm(ckv, self.w_uk).reshape(T, H, nope),
                           kr.expand(T, H, rr)], dim=-1)
            v = mm(ckv, self.w_uv).reshape(T, H, c["v_head_dim"])
            o = attend(q, k, v, 1.0 / math.sqrt(nope + rr), None)
        else:
            kvh = c["num_key_value_heads"]
            hd = c["hidden_size"] // H
            q = rope(mm(h, self.w_q).reshape(T, H, hd), pos, theta)
            k = rope(mm(h, self.w_k).reshape(T, kvh, hd), pos, theta)
            v = mm(h, self.w_v).reshape(T, kvh, hd)
            o = attend(q, k, v, 1.0 / math.sqrt(hd),
                       c.get("sliding_window"))
        return mm(o.reshape(T, -1), self.w_o)

    def _moe(self, h: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        k = c["num_experts_per_tok"]
        probs = torch.softmax(self.prec.mm(h, self.router), dim=-1)
        top_p, top_e = torch.topk(probs, k, dim=-1)
        if c["norm_topk_prob"]:
            top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        out = self._swiglu(h, self.mlp)
        for e, ws in enumerate(self.experts):
            tok, slot = torch.nonzero(top_e == e, as_tuple=True)
            if tok.numel():
                y = self._swiglu(h[tok], ws) * top_p[tok, slot][:, None]
                out.index_add_(0, tok, y)
        return out

    def __call__(self, xs: "list[torch.Tensor]") -> "list[torch.Tensor]":
        """The layer over each sequence of xs: attention one sequence at a
        time, the position-wise half over all their rows at once."""
        eps = self.cfg["rms_norm_eps"]
        xs = [x + self._attention(rmsnorm(x, self.ln1, eps)) for x in xs]
        x = torch.cat(xs)
        h = rmsnorm(x, self.ln2, eps)
        x = x + (self._moe(h) if self.kind == "moe"
                 else self._swiglu(h, self.mlp))
        return list(torch.split(x, [len(t) for t in xs]))


def layer_kinds(cfg: dict) -> "list[str]":
    """'dense' or 'moe' for each layer, as the published config places
    them (`first_k_dense_replace` leading dense layers)."""
    n = cfg["num_hidden_layers"]
    if not cfg.get("n_routed_experts"):
        return ["dense"] * n
    k = cfg.get("first_k_dense_replace", 0)
    return ["dense"] * k + ["moe"] * (n - k)


def layer_tree(params: dict, i: int, n_prefix: int) -> dict:
    """Layer i's leaves: a leading layer of `prefix`, else layer i -
    n_prefix of the stacked `blocks.b0`."""
    if i < n_prefix:
        return params["prefix"][i]

    def pick(t):
        return ({k: pick(v) for k, v in t.items()} if isinstance(t, dict)
                else t[i - n_prefix])
    return pick(params["blocks"]["b0"])


@torch.no_grad()
def logits_at(cfg: dict, params: dict, seqs: "list[torch.Tensor]",
              rows: "list[torch.Tensor]", quant: "str | None" = None
              ) -> "list[torch.Tensor]":
    """f32 logits (len(rows[i]), vocab) at positions rows[i] of each token
    sequence seqs[i] (1-D int tensors on the parameters' device), computed
    layer by layer over all sequences so each layer's weights are widened
    once."""
    prec = Precision(quant)
    kinds = layer_kinds(cfg)
    n_prefix = len(params["prefix"])
    emb = params["embed"]["embedding"]
    xs = [_f32(emb[s]) for s in seqs]
    for i, kind in enumerate(kinds):
        layer = Layer(cfg, layer_tree(params, i, n_prefix), kind, prec)
        xs = layer(xs)
        del layer
    w_out = prec.weight(params["lm_head"]["w_out"]).t()
    eps = cfg["rms_norm_eps"]
    return [prec.mm(rmsnorm(x[r], params["final_norm"]["scale"], eps), w_out)
            for x, r in zip(xs, rows)]
