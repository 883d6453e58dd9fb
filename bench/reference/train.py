"""Plain float32 PyTorch training steps of the benchmark's dense window
configurations: the causal LM loss, its gradients by autograd, and AdamW
with global-norm clipping, as the job states them.

The model is `model.py`'s (RMSNorm, split-half RoPE, GQA with a sliding
window, SwiGLU, an untied head), written here over f32 leaves that
autograd follows, one layer checkpointed at a time and attention in query
blocks, so a full-size step fits the card.  `quant="fp8"` rounds both
operands of every weight product to float8 e4m3, in the forward and in
both products of the backward: the control.

AdamW: g' = g * min(1, clip / (||g|| + 1e-9)); m = b1 m + (1 - b1) g';
v = b2 v + (1 - b2) g'^2; p -= lr (m / (1 - b1^t) / (sqrt(v / (1 - b2^t))
+ eps) + wd p) on every leaf; lr from the job's cosine schedule with a
linear warm-up.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference.model import Q_CHUNK, _q8, rmsnorm, rope


class _Fp8Product(torch.autograd.Function):
    """x (..., K) @ w (K, N) with both operands in e4m3, forward and
    backward."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _q8(x, -1), _q8(w, None)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _q8(g, -1)
        gx = gq @ wq.t()
        gw = xq.reshape(-1, xq.shape[-1]).t() @ gq.reshape(-1, g.shape[-1])
        return gx, gw


def _mm(x, w, quant):
    return _Fp8Product.apply(x, w) if quant else x @ w


def _attend(q, k, v, window):
    """q (B, T, H, hd), k / v (B, T, KVH, hd): causal, windowed."""
    B, T, H, hd = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    kpos = torch.arange(T, device=q.device)
    out = []
    for s in range(0, T, Q_CHUNK):
        e = min(T, s + Q_CHUNK)
        lo = 0 if window is None else max(0, s - window + 1)
        qpos = torch.arange(s, e, device=q.device)[:, None]
        mask = kpos[None, lo:e] <= qpos
        if window is not None:
            mask &= kpos[None, lo:e] > qpos - window
        sc = torch.einsum("bshd,bthd->bhst", q[:, s:e], k[:, lo:e]) \
            / math.sqrt(hd)
        sc = sc.masked_fill(~mask, float("-inf"))
        out.append(torch.einsum("bhst,bthd->bshd", torch.softmax(sc, -1),
                                v[:, lo:e]))
    return torch.cat(out, dim=1)


def _layer(cfg, quant, x, ln1, wq, wk, wv, wo, ln2, wg, wu, wd):
    B, T, d = x.shape
    H, kvh = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // H
    eps, theta = cfg["rms_norm_eps"], float(cfg["rope_theta"])
    pos = torch.arange(T, device=x.device)
    h = rmsnorm(x, ln1, eps)

    def rot(t):            # (B, T, n, hd): rope over T, each row alike
        return rope(t.transpose(0, 1), pos, theta).transpose(0, 1)
    q = rot(_mm(h, wq, quant).reshape(B, T, H, hd))
    k = rot(_mm(h, wk, quant).reshape(B, T, kvh, hd))
    v = _mm(h, wv, quant).reshape(B, T, kvh, hd)
    o = _attend(q, k, v, cfg.get("sliding_window"))
    x = x + _mm(o.reshape(B, T, H * hd), wo, quant)
    h = rmsnorm(x, ln2, eps)
    f = torch.nn.functional.silu(_mm(h, wg, quant)) * _mm(h, wu, quant)
    return x + _mm(f, wd, quant)


LAYER_LEAVES = (("ln1", "scale"), ("attn", "w_q"), ("attn", "w_k"),
                ("attn", "w_v"), ("attn", "w_o"), ("ln2", "scale"),
                ("mlp", "w_gate"), ("mlp", "w_up"), ("mlp", "w_down"))


def leaves(params: dict) -> "dict[tuple, torch.Tensor]":
    """The f32 copies the reference trains, keyed by their path in the
    tree (the stacked layer leaves stay stacked)."""
    out = {("embed", "embedding"): params["embed"]["embedding"],
           ("final_norm", "scale"): params["final_norm"]["scale"],
           ("lm_head", "w_out"): params["lm_head"]["w_out"]}
    for a, b in LAYER_LEAVES:
        out[("blocks", "b0", a, b)] = params["blocks"]["b0"][a][b]
    return {k: v.detach().to(torch.float32).clone() for k, v in out.items()}


def loss(cfg: dict, p: dict, tokens, labels, quant=None) -> torch.Tensor:
    """Mean token NLL of labels (B, T) given tokens (B, T)."""
    x = p[("embed", "embedding")][tokens]
    stacked = [p[("blocks", "b0", a, b)] for a, b in LAYER_LEAVES]
    for i in range(cfg["num_hidden_layers"]):
        ln1, wq, wk, wv, wo, ln2, wg, wu, wd = (w[i] for w in stacked)
        d = wq.shape[0]
        # (d, heads, hd) -> (d, heads * hd); w_o (heads, hd, d) -> (.., d)
        x = checkpoint(_layer, cfg, quant, x, ln1, wq.reshape(d, -1),
                       wk.reshape(d, -1), wv.reshape(d, -1),
                       wo.reshape(-1, d), ln2, wg, wu, wd,
                       use_reentrant=False)
    x = rmsnorm(x, p[("final_norm", "scale")], cfg["rms_norm_eps"])
    B, T, d = x.shape
    total = x.new_zeros(())
    w_out = p[("lm_head", "w_out")]
    for s in range(0, T, 512):
        def chunk(xc, lc, w):
            lg = _mm(xc, w.t(), quant)
            return torch.nn.functional.cross_entropy(
                lg.reshape(-1, lg.shape[-1]), lc.reshape(-1).long(),
                reduction="sum")
        total = total + checkpoint(chunk, x[:, s:s + 512],
                                   labels[:, s:s + 512], w_out,
                                   use_reentrant=False)
    return total / (B * T)


def cosine_lr(step: int, peak: float, warmup: int, total: int,
              floor_frac: float = 0.1) -> float:
    if step < warmup:
        return peak * step / max(1, warmup)
    prog = min(1.0, max(0.0, (step - warmup) / max(1, total - warmup)))
    return peak * (floor_frac + (1 - floor_frac) * 0.5
                   * (1 + math.cos(math.pi * prog)))


class AdamW:
    def __init__(self, p: dict, opt: dict):
        self.o = opt
        self.m = {k: torch.zeros_like(v) for k, v in p.items()}
        self.v = {k: torch.zeros_like(v) for k, v in p.items()}
        self.t = 0

    @torch.no_grad()
    def update(self, p: dict, g: dict, lr: float) -> None:
        o = self.o
        norm = math.sqrt(sum(float(torch.sum(x * x)) for x in g.values()))
        scale = min(1.0, o["clip_norm"] / (norm + 1e-9))
        self.t += 1
        b1c = 1 - o["b1"] ** self.t
        b2c = 1 - o["b2"] ** self.t
        for k in p:
            gk = g[k] * scale
            self.m[k].mul_(o["b1"]).add_((1 - o["b1"]) * gk)
            self.v[k].mul_(o["b2"]).add_((1 - o["b2"]) * gk * gk)
            step = (self.m[k] / b1c) / (torch.sqrt(self.v[k] / b2c)
                                        + o["eps"]) \
                + o["weight_decay"] * p[k]
            p[k].sub_(lr * step)


def train_steps(cfg: dict, params: dict, batches, opt: dict, first_step: int,
                quant=None):
    """Run len(batches) steps from `params` (left as they were).  Returns
    (losses, the first gradient as the optimizer got it per leaf: its
    norm, the change of each leaf after the steps: its norm)."""
    p = leaves(params)
    adam = AdamW(p, opt)
    losses, first = [], None
    for i, (tokens, labels) in enumerate(batches):
        live = {k: v.requires_grad_() for k, v in p.items()}
        lv = loss(cfg, live, tokens, labels, quant)
        grads = torch.autograd.grad(lv, list(live.values()))
        g = dict(zip(live.keys(), grads))
        for v in live.values():
            v.requires_grad_(False)
        losses.append(float(lv.detach()))
        if first is None:
            norm = math.sqrt(sum(float(torch.sum(x * x)) for x in g.values()))
            scale = min(1.0, opt["clip_norm"] / (norm + 1e-9))
            first = {k: float(torch.linalg.vector_norm(x)) * scale
                     for k, x in g.items()}
        adam.update(p, g, cosine_lr(first_step + i, opt["lr"],
                                    opt["warmup"], opt["total"]))
        del grads, g, lv
    p0 = leaves(params)
    change = {k: float(torch.linalg.vector_norm(p[k] - p0[k])) for k in p}
    return losses, first, change
