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
