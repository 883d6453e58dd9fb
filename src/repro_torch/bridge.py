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
from repro_torch.core.streamer import StreamSettings


def tensor_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    # a C-order copy when needed (a view of a jax array is read-only);
    # not np.ascontiguousarray, which makes a 0-d array (a step count) 1-d
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, device="cpu"):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors
    (None leaves, a cross layer's empty cache, stay None).  Every leaf
    keeps its dtype: the f32 leaves of a bf16 model (the SSM's A_log / D /
    dt_bias, the xLSTM gate biases) stay f32."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return tensor_from_numpy(np.asarray(tree), device)


def _fields(cls, ref) -> dict:
    return {f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)}


def config_from_reference(ref_cfg) -> ModelConfig:
    """The port's ModelConfig with every field read from the reference
    config object of the same name (fields the port lacks are ignored);
    the reference's `StreamSettings` becomes the port's."""
    kw = _fields(ModelConfig, ref_cfg)
    kw["stream"] = StreamSettings(**_fields(StreamSettings, kw["stream"]))
    return ModelConfig(**kw)


def opt_state_from_numpy(tree, device="cpu"):
    """The reference's optimizer state as numpy trees -> the port's:
    AdamW's {"mu", "nu", "count"} or Adafactor's {"factors", "count"}
    (each leaf keeps its dtype: f32 moments and factors, an int32
    count)."""
    if set(tree) not in ({"mu", "nu", "count"}, {"factors", "count"}):
        raise ValueError(f"not an AdamW or Adafactor state: keys "
                         f"{sorted(tree)}")
    return params_from_numpy(tree, device)
