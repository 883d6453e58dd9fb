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
