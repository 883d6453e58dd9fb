"""Bring the reference's parameters and configs into the port.

The reference's parameter pytree arrives as nested dicts/lists of numpy
arrays (e.g. `jax.tree.map(np.asarray, params)` on the caller's side); bf16
leaves are ml_dtypes `bfloat16` arrays, recognised here by dtype name and
reinterpreted through their 16-bit pattern, so this module needs neither
jax nor ml_dtypes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def tensor_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:             # e.g. a view of a jax array
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, device="cpu"):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return tensor_from_numpy(np.asarray(tree), device)


def config_from_reference(ref_cfg) -> ModelConfig:
    """The port's ModelConfig with every field read from the reference
    config object of the same name (fields the port lacks are ignored)."""
    return ModelConfig(**{f.name: getattr(ref_cfg, f.name)
                          for f in dataclasses.fields(ModelConfig)})
