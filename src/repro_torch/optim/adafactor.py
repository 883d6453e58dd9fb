"""Adafactor (Shazeer & Stern 2018), the port's copy of
`repro.optim.adafactor`: factored second moments for leaves of rank >= 2
(a row factor over the leading dims and a column factor over the last),
an unfactored one for 1-D leaves, no first moment, update clipping
(RMS(u) <= clip_threshold) and the RMS parameter scale.  State per
factored leaf is (r + c) f32 numbers against AdamW's 2 r c.  The train
steps donate the parameters and the state (`donate=True`: updated in
place), as `adamw_update`'s.

On a mesh (the ambient one of `dist.collectives`, with the leaves' specs)
each rank holds its piece of every parameter and gradient, and the factors
whole, as the reference's specs keep them (replicated).  Every mean is
over the whole leaf: a mean along a dim that the leaf splits is the
all-reduced sum of the pieces' sums over the whole length, the new row and
column factors are gathered whole from the pieces, and a rank scales its
piece by its block of them.  A dim split over no axis of more than one rank
takes `torch.mean` as the mesh-less update does, so a 1x1 mesh gives its
numbers bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.dist import sharding as shd
from repro_torch.dist.collectives import all_reduce, current
from repro_torch.models.layers import Spec, map_specs, tree_leaves, tree_map
from repro_torch.optim.adamw import global_norm


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


class _Leaf:
    """The whole-leaf means and the factor pieces of one leaf's piece on
    the ambient mesh `par` under `spec` (no mesh: the leaf is whole)."""

    def __init__(self, spec, par, shape):
        self.par = par
        self.spec = tuple(spec) if (spec and par) else (None,) * len(shape)
        self.axes = [tuple(a for a in shd.entry_axes(e) if par.size(a) > 1)
                     if par else () for e in self.spec]

    def _sub(self, dims):
        return tuple(None if d is None else self.spec[d] for d in dims)

    def mean(self, x, dim: int):
        """The mean of the whole leaf's dim `dim` from the piece x."""
        axes = self.axes[dim]
        if not axes:
            return torch.mean(x, dim=dim)
        n = x.shape[dim] * self.par.size(axes)
        return all_reduce(torch.sum(x, dim=dim), self.par, axes) / n

    def mean_all(self, x):
        axes = tuple(a for ax in self.axes for a in ax)
        if not axes:
            return torch.mean(x)
        return all_reduce(torch.sum(x), self.par, axes) / (
            x.numel() * self.par.size(axes))

    def whole(self, t, dims):
        """t whole, its dims laid out as the leaf's `dims` (a gather)."""
        return shd.whole(t, self._sub(dims), self.par.mesh) if self.par \
            else t

    def piece(self, t, dims):
        """The rank's block of a whole t laid out as the leaf's `dims`."""
        return shd.piece(t, self._sub(dims), self.par.mesh) if self.par \
            else t


@torch.no_grad()
def adafactor_update(cfg: AdafactorConfig, grads, state, params, lr=None,
                     specs=None, donate: bool = False):
    """Returns (params, state, metrics {"lr", "grad_norm"}).  With `donate`
    the parameters and the state are updated in their own storage, one
    leaf at a time, and the trees given come back (`adamw_update`'s
    contract; the reference's arithmetic op for op).  `specs`: the leaves'
    pieces on the ambient mesh (module docstring)."""
    if not donate:
        params, state = tree_map(torch.clone, (params, state))
    count = state["count"].add_(1)
    t = count.float()
    beta2 = 1.0 - torch.pow(t, -cfg.decay)
    lr_t = torch.as_tensor(cfg.lr if lr is None else lr,
                           dtype=torch.float32, device=count.device)
    par = current() if specs is not None else None

    def ema(v, new):
        """v <- beta2 v + (1 - beta2) new, in v."""
        v.mul_(beta2).add_((1 - beta2) * new)

    def upd(p, g, st, spec=None):
        lf = _Leaf(spec, par, p.shape)
        nd = p.ndim
        g = g.float()
        g2 = g * g + cfg.eps1
        if _factored(p.shape):
            rows, cols = range(nd - 1), (*range(nd - 2), nd - 1)
            vr, vc = st["vr"], st["vc"]
            ema(vr, lf.whole(lf.mean(g2, -1), rows))
            ema(vc, lf.whole(lf.mean(g2, -2), cols))
            # v_hat ~ vr vc / mean(vr)
            denom = torch.mean(vr, dim=-1, keepdim=True)
            vr_l, vc_l = lf.piece(vr, rows), lf.piece(vc, cols)
            denom_l = lf.piece(denom, (*range(nd - 2), None))
            vhat = (vr_l[..., None] * vc_l[..., None, :]
                    / torch.clamp(denom_l[..., None], min=cfg.eps1))
            u = g * torch.rsqrt(torch.clamp(vhat, min=cfg.eps1))
        else:
            ema(st["v"], lf.whole(g2, range(nd)))
            u = g * torch.rsqrt(torch.clamp(lf.piece(st["v"], range(nd)),
                                            min=cfg.eps1))
        rms = torch.sqrt(lf.mean_all(u * u))
        u = u / torch.clamp(rms / cfg.clip_threshold, min=1.0)
        pf = p.float()
        scale = torch.clamp(torch.sqrt(lf.mean_all(pf ** 2)), min=cfg.eps2)
        p.copy_(pf - lr_t * scale * u - lr_t * cfg.weight_decay * pf)

    if par is None:
        tree_map(upd, params, grads, state["factors"])
    else:
        shd.map_spec_tree(lambda s, p, g, st: upd(p, g, st, s), specs,
                          params, grads, state["factors"])
    gnorm = global_norm(grads, specs if par is not None else None)
    return params, state, {"lr": lr_t, "grad_norm": gnorm}
