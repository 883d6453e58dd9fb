"""RMSNorm on the H100 with a row's bits fixed by the row alone.

`rmsnorm(x, scale, eps)` launches `rmsnorm_kernel` (`csrc/rmsnorm.cu`):
one CTA a row, its threads from the width alone, a fixed summation order,
so a token's normalised row is the same bits whether it rides in a decode
step (one row a lane) or a verify step (draft_len + 1 rows).  The plain
version is `kernels.ref.rmsnorm_ref`, which `kernels.ops.rmsnorm` runs on
the CPU.  Not the port of a TPU kernel: the JAX package leaves RMSNorm to
XLA.

CUDA tensors only: a CPU tensor, or a width that is not a multiple of 8,
raises.  Each launch adds one to `launches_rmsnorm`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches_rmsnorm = build.LaunchCounter()


def _lib() -> ctypes.CDLL:
    lib = build.load("rmsnorm")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rmsnorm_launch.argtypes = [p, ctypes.c_longlong, p, p, i, i,
                                       ctypes.c_float, i, p]
        lib.rmsnorm_launch.restype = i
        lib.rmsnorm_error_string.argtypes = [i]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * scale over x's last dim, in f32, cast
    to x.dtype.  x: (..., d) float32 or bfloat16, d a multiple of 8; its
    rows may be strided (a slice of a wider row) as long as each row is
    contiguous and 16-byte aligned, else it is copied first.  scale: (d,)
    in x's dtype."""
    d = x.shape[-1]
    if not x.is_cuda:
        raise ValueError(f"rmsnorm launches a CUDA kernel and needs CUDA "
                         f"tensors, got x on {x.device} (the plain version "
                         "is kernels.ref.rmsnorm_ref; kernels.ops.rmsnorm "
                         "routes by device)")
    if scale.device != x.device:
        raise ValueError(f"scale on {scale.device}, x on {x.device}")
    if x.dtype not in DTYPES or scale.dtype != x.dtype:
        raise TypeError(f"rmsnorm takes float32 or bfloat16 x and a scale "
                        f"of its dtype, got {x.dtype} / {scale.dtype}")
    if tuple(scale.shape) != (d,):
        raise ValueError(f"scale {tuple(scale.shape)} does not match width "
                         f"{d}")
    if d < 8 or d % 8:
        raise ValueError(f"the rmsnorm kernel takes widths that are "
                         f"multiples of 8 (16-byte vectors), got {d}")
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    x2 = x.reshape(-1, d)
    rows = x2.shape[0]
    if rows == 0:
        return y
    es = x.element_size()
    stride = x2.stride(0) if rows > 1 else d
    if x2.stride(1) != 1 or stride < d or (stride * es) % 16 \
            or x2.data_ptr() % 16:
        x2, stride = x2.contiguous(), d
    sc = scale.contiguous()
    if sc.data_ptr() % 16:
        sc = sc.clone()
    lib = _lib()
    err = lib.rmsnorm_launch(
        x2.data_ptr(), stride, sc.data_ptr(), y.data_ptr(),
        rows, d, eps, DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "rmsnorm")
    launches_rmsnorm.n += 1
    return y

