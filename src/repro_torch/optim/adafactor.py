"""Adafactor (Shazeer & Stern 2018), the port's copy of
`repro.optim.adafactor`: factored second moments for leaves of rank >= 2
(a row factor over the leading dims and a column factor over the last),
an unfactored one for 1-D leaves, no first moment, update clipping
(RMS(u) <= clip_threshold) and the RMS parameter scale.  State per
factored leaf is (r + c) f32 numbers against AdamW's 2 r c.  The update is
functional, as `adamw_update`'s.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.layers import Spec, map_specs, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8            # beta2_t = 1 - t^-decay
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_threshold: float = 1.0
    weight_decay: float = 0.0


def _factored(shape) -> bool:
    return len(shape) >= 2


def _state_shapes(shape) -> dict:
    shape = tuple(shape)
    if _factored(shape):
        return {"vr": shape[:-1], "vc": shape[:-2] + shape[-1:]}
    return {"v": shape}


def adafactor_init(params):
    def st(p):
        return {k: torch.zeros(s, dtype=torch.float32, device=p.device)
                for k, s in _state_shapes(p.shape).items()}
    dev = tree_leaves(params)[0].device
    return {"factors": tree_map(st, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def adafactor_state_specs(param_specs):
    def st(_, s: Spec):
        return {k: Spec(shape, torch.float32)
                for k, shape in _state_shapes(s.shape).items()}
    return {"factors": map_specs(st, param_specs),
            "count": Spec((), torch.int32)}


@torch.no_grad()
def adafactor_update(cfg: AdafactorConfig, grads, state, params, lr=None):
    """Returns (new_params, new_state, metrics {"lr", "grad_norm"})."""
    count = state["count"] + 1
    t = count.float()
    beta2 = 1.0 - torch.pow(t, -cfg.decay)
    lr_t = torch.as_tensor(cfg.lr if lr is None else lr,
                           dtype=torch.float32, device=count.device)

    def upd(p, g, st):
        g = g.float()
        g2 = g * g + cfg.eps1
        if _factored(p.shape):
            vr = beta2 * st["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * st["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
            # v_hat ~ vr vc / mean(vr)
            denom = torch.mean(vr, dim=-1, keepdim=True)
            vhat = (vr[..., None] * vc[..., None, :]
                    / torch.clamp(denom[..., None], min=cfg.eps1))
            u = g * torch.rsqrt(torch.clamp(vhat, min=cfg.eps1))
            new_st = {"vr": vr, "vc": vc}
        else:
            v = beta2 * st["v"] + (1 - beta2) * g2
            u = g * torch.rsqrt(torch.clamp(v, min=cfg.eps1))
            new_st = {"v": v}
        rms = torch.sqrt(torch.mean(u * u))
        u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        pf = p.float()
        scale = torch.clamp(torch.sqrt(torch.mean(pf ** 2)), min=cfg.eps2)
        newp = pf - lr_t * scale * u - lr_t * cfg.weight_decay * pf
        return newp.to(p.dtype), new_st

    outs = tree_map(upd, params, grads, state["factors"])
    new_params, new_factors = _unzip(outs, 0), _unzip(outs, 1)
    gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                           for g in tree_leaves(grads)))
    return new_params, {"factors": new_factors, "count": count}, {
        "lr": lr_t, "grad_norm": gnorm}


def _unzip(tree, i: int):
    """Element i of every (new param, new state) pair of `tree` (`tree_map`
    makes lists of sequences, so its only tuples are the pairs)."""
    if isinstance(tree, tuple):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    return [_unzip(v, i) for v in tree]
