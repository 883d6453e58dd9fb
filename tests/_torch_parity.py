"""Helpers shared by the tests that hold the PyTorch port against the JAX
package: both sides get the same numpy arrays."""
from __future__ import annotations

import numpy as np
import torch

import jax

from repro_torch.bridge import params_from_numpy


def t(a) -> torch.Tensor:
    """A numpy / jax array as a CPU tensor (bf16 through its bit pattern)."""
    return params_from_numpy(np.asarray(a))


def np32(x) -> np.ndarray:
    """A tensor or jax array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def tree_to_torch(tree):
    """A JAX parameter / cache pytree as the port's tree of CPU tensors."""
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def ring_replay(S: int, G: int, C: int):
    """Run `gpp::run_chunk_schedule` (csrc/ring.cuh) for steps 0..S-1 as a
    kernel does, commit groups and all: for G >= 2, step 0 commits A (tile
    0) and P (the folded prologue), every step B (chunk C-1 of tile s+1)
    and R (chunk C-d of tile s+d, d >= 2), then waits with wait_group 3;
    G == 1 commits one group and waits with wait_group 0.  The tensor-core
    matmul kernels' issue callbacks add the step's x tile to the call that
    issues its chunk C-1 (`x_at`; the MLA kernel has no such tile and
    ignores it).  Returns ({(step, chunk): [issue_steps]}, {step: (step
    issuing its x tile, group index)}, {step: group index each W chunk of
    the step went out in}, {step: the number of groups landed at its
    wait})."""
    order, x_at, chunk_groups, landed = {}, {}, {}, {}
    groups = 0                         # commit groups so far

    def issue(s, t, c):
        order.setdefault((t, c), []).append(s)
        chunk_groups.setdefault(t, []).append(groups)
        if c == C - 1:
            x_at[t] = (s, groups)

    for s in range(S):
        if G == 1:
            issue(s, s, 0)
            groups += 1
            landed[s] = groups         # wait_group 0
            continue
        if s == 0:
            for c in range(C):
                issue(s, 0, c)
            groups += 1                # A
            for d in range(1, min(C, S)):
                for c in range(C - d):
                    issue(s, d, c)
            groups += 1                # P
        if s + 1 < S:
            issue(s, s + 1, C - 1)
        groups += 1                    # B
        for d in range(2, G):
            c = C - d
            if c >= 0 and s + d < S:
                issue(s, s + d, c)
        groups += 1                    # R
        landed[s] = groups - 3         # wait_group 3: all but the newest 3
    return order, x_at, chunk_groups, landed


def walk_checks(plan):
    """What every split plan of the FMA route of `gpp_matmul` and
    `gpp_matmul_grouped` (`core.schedule.MatmulFmaPlan`) must hold: each
    unit walked once, in order, by balanced runs; the kernel's `owner`;
    each tile's segments covering its k-steps once in segment order; units
    tile-major with the k-step inner, each tile one (expert, n-tile,
    m-tile); every partial of a split tile in a workspace slot of its own."""
    walked = [u for i in range(plan.grid) for u in plan.cta_units(i)]
    assert walked == list(range(plan.units))      # once each, in order
    sizes = {plan.cta_steps(i) for i in range(plan.grid)}
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    for u in range(plan.units):                   # the kernel's owner()
        assert u in plan.cta_units(plan.owner(u))
    slots = set()
    for tile in range(plan.tiles):
        segs = plan.segments(tile)
        assert len(segs) <= plan.max_segs
        # the CTAs sharing a tile cover its k-steps once, in segment order
        ks = [plan.unit(u)[1] for i in segs for u in plan.cta_units(i)
              if plan.unit(u)[0] == tile]
        assert ks == list(range(plan.num_k))
        if len(segs) > 1:        # each partial has a slot of its own; a
            for i in segs:       # later segment's run starts in the tile
                slot = plan.slot(i, tile)
                assert 2 * i <= slot < 2 * i + 2 and slot not in slots
                assert i == segs[0] or slot == 2 * i
                slots.add(slot)
    # units tile-major, the k-step inner; every (expert, n-tile, m-tile) a
    # tile once
    assert [plan.unit(u) for u in range(plan.units)] == \
        [(tl, k) for tl in range(plan.tiles) for k in range(plan.num_k)]
    assert sorted((plan.expert(tl), *plan.tile(tl))
                  for tl in range(plan.tiles)) == \
        [(e, n, m) for e in range(plan.E) for n in range(plan.n_tiles)
         for m in range(plan.m_tiles)]

def same_values(got, want, rel: float = 1e-9, path: str = "") -> None:
    """Dataclasses, tuples / lists and dicts of numbers and strings, field
    by field: ints, bools and strings equal, floats within `rel`
    (relative, absolute at magnitudes under 1)."""
    import dataclasses
    import math
    if dataclasses.is_dataclass(got):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(got):
            same_values(getattr(got, f.name), getattr(want, f.name), rel,
                        f"{path}.{f.name}")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same_values(g, w, rel, f"{path}[{i}]")
    elif isinstance(got, dict):
        assert got.keys() == want.keys(), path
        for k in got:
            same_values(got[k], want[k], rel, f"{path}[{k!r}]")
    elif isinstance(got, float) or isinstance(want, float):
        if math.isinf(want) or math.isnan(want):
            assert got == want or (math.isnan(got) and math.isnan(want)), \
                path
        else:
            assert abs(got - want) <= rel * max(1.0, abs(want)), \
                (path, got, want)
    else:
        assert got == want, (path, got, want)
