"""Random weights from the seed, made on the device in a few large calls.

The benchmark, not the program, makes the weights: it takes the tree of
shapes and dtypes the program serves (`specs`, nested dicts / lists of
objects with `.shape` and `.dtype`), draws one flat buffer per dtype from a
`torch.Generator` on the device, and hands out views of it.  The same tree
goes to the program and to the plain reference.

Values: normal(0, scale) clipped at two standard deviations for every
weight matrix; ones for every RMSNorm weight (a leaf named `scale` or
`*_norm`); zeros for biases.
"""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 28         # elements drawn by one call


def leaves(tree, path=()):
    """(path, leaf) of nested dicts / lists; a leaf has a `.shape`."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def _rebuild(tree, made, path=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, made, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        return [_rebuild(v, made, path + (i,)) for i, v in enumerate(tree)]
    return made[path]


def kind_of(path) -> str:
    name = str(path[-1])
    if name == "scale" or name.endswith("_norm"):
        return "ones"
    if name.startswith("b_") or "bias" in name:
        return "zeros"
    return "normal"


def make_params(specs, seed: int, device, scale: float = 0.02) -> dict:
    """The parameter tree of `specs`, drawn from `seed` on `device`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    by_dtype: "dict[torch.dtype, list]" = {}
    for path, s in leaves(specs):
        by_dtype.setdefault(s.dtype, []).append((path, s))
    made = {}
    for dtype, group in by_dtype.items():
        sizes = [math.prod(s.shape) for _, s in group]
        flat = torch.empty(sum(sizes), dtype=dtype, device=device)
        for a in range(0, flat.numel(), CHUNK):
            part = flat[a:a + CHUNK]
            part.normal_(0.0, scale, generator=gen)
            part.clamp_(-2 * scale, 2 * scale)
        off = 0
        for (path, s), n in zip(group, sizes):
            view = flat[off:off + n].view(s.shape)
            off += n
            k = kind_of(path)
            if k == "ones":
                view.fill_(1.0)
            elif k == "zeros":
                view.zero_()
            made[path] = view
    return _rebuild(specs, made)
