"""`gpp_matmul`: the generalized ping-pong streaming matmul on the H100.

y[M, N] = act((x[M, K] @ W[K, N]) * w_scale + bias) with f32 accumulation —
the port of `repro/kernels/gpp_matmul.py::gpp_matmul`.  On a CUDA tensor the
wrapper launches the hand-written kernel in `csrc/gpp_matmul.cu`: each CTA
owns one (block_m, 64) output tile and streams its k-steps' W tiles through
a G-slot shared-memory ring on the paper's chunk schedule (`csrc/ring.cuh`;
G from `core.schedule.plan_matmul_sm90`).  On a CPU tensor it computes the
plain version, `kernels.ref.dense_ref`.  There is no other route: a CUDA
tensor the kernel cannot take raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.schedule import plan_matmul_sm90
from repro_torch.kernels import build
from repro_torch.kernels.ref import ACTIVATION_IDS, dense_ref

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
W_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

launches = build.LaunchCounter()


def _lib() -> ctypes.CDLL:
    lib = build.load("gpp_matmul")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gpp_matmul_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                          i, i, i, i, p, p]
        lib.gpp_matmul_launch.restype = i
        lib.gpp_matmul_error_string.argtypes = [i]
        lib.gpp_matmul_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _ptr(t: "torch.Tensor | None"):
    return None if t is None else t.data_ptr()


def gpp_matmul(x: torch.Tensor, w: torch.Tensor, *,
               bias: "torch.Tensor | None" = None, w_scale=None,
               activation: "str | None" = None,
               num_bufs: "int | None" = None,
               record: "torch.Tensor | None" = None) -> torch.Tensor:
    """Streaming matmul with the generalized ping-pong shared-memory ring.

    x: (M, K) f32/bf16; w: (K, N) f32/bf16/int8 (copied raw, widened on
    chip); bias: (N,); w_scale: scalar or (N,) dequant scale applied to the
    f32 accumulator; activation: none | relu | gelu (tanh) | silu | tanh |
    sigmoid.  Output in x.dtype.  num_bufs pins the ring depth G (1 in-situ,
    2 naive ping-pong, >= 3 GPP); None plans it.  record: optional int32
    CUDA tensor that receives CTA (0, 0)'s (step, chunk, issue_step) triples
    (see `issue_order`).
    """
    if activation not in ACTIVATION_IDS:
        raise ValueError(f"unknown activation {activation!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gpp_matmul wants (M,K) @ (K,N), got "
                         f"x{tuple(x.shape)} w{tuple(w.shape)}")
    if not x.is_cuda:
        return dense_ref(x, w, bias=bias, w_scale=w_scale,
                         activation=activation)
    M, K = x.shape
    N = w.shape[1]
    dev = x.device
    if w.device != dev:
        raise ValueError(f"x on {dev} but w on {w.device}")
    if x.dtype not in X_DTYPES or w.dtype not in W_DTYPES:
        raise TypeError(f"unsupported dtypes x {x.dtype}, w {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("gpp_matmul needs contiguous x and w")
    scale = None
    if w_scale is not None:
        scale = torch.as_tensor(w_scale, dtype=torch.float32, device=dev)
        if scale.numel() not in (1, N):
            raise ValueError(f"w_scale must be a scalar or ({N},)")
        scale = scale.reshape(-1).expand(N).contiguous()
    b = None
    if bias is not None:
        if bias.numel() != N or bias.device != dev:
            raise ValueError(f"bias must be ({N},) on {dev}")
        b = bias.reshape(N).to(torch.float32).contiguous()
    plan = plan_matmul_sm90(M, K, N, w_itemsize=w.element_size(),
                            num_bufs=num_bufs)
    if record is not None and (record.dtype != torch.int32
                               or record.device != dev):
        raise ValueError("record must be an int32 tensor on the same device")
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    vec = build.copy_width(N * w.element_size(), w.data_ptr())
    lib = _lib()
    err = lib.gpp_matmul_launch(
        x.data_ptr(), w.data_ptr(), _ptr(scale), _ptr(b), y.data_ptr(),
        M, K, N, X_DTYPES[x.dtype], W_DTYPES[w.dtype], plan.block_m,
        plan.block_k, plan.num_bufs, plan.chunks, ACTIVATION_IDS[activation],
        vec, _ptr(record), torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(lib, err, "gpp_matmul")
    launches.n += 1
    return y


def issue_order(x: torch.Tensor, w: torch.Tensor, num_bufs: int):
    """Run one launch with the issue-order record on and return
    ({(step, chunk): [issue_steps]}, num_k, G, C) for CTA (0, 0) — the
    structure `kernels.ref.chunk_issue_schedule(num_k, G, C)` returns."""
    M, K = x.shape
    plan = plan_matmul_sm90(M, K, w.shape[1], w_itemsize=w.element_size(),
                            num_bufs=num_bufs)
    num_k = plan.grid(M, w.shape[1], K)[2]
    rec = torch.full((3 * num_k * plan.chunks,), -1, dtype=torch.int32,
                     device=x.device)
    gpp_matmul(x, w, num_bufs=num_bufs, record=rec)
    order: "dict[tuple[int, int], list[int]]" = {}
    for step, chunk, at in rec.view(-1, 3).tolist():
        if step >= 0:
            order.setdefault((step, chunk), []).append(at)
    return order, num_k, plan.num_bufs, plan.chunks
