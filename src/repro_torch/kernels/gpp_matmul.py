"""`gpp_matmul` and `gpp_matmul_grouped`: the generalized ping-pong
streaming matmuls on the H100.

`gpp_matmul`: y[M, N] = act((x[M, K] @ W[K, N]) * w_scale + bias) with f32
accumulation — the port of `repro/kernels/gpp_matmul.py::gpp_matmul`.  The
wrapper launches the hand-written kernel in `csrc/gpp_matmul.cu`: each CTA
owns one (block_m, 64) output tile and streams its k-steps' W tiles through
a G-slot shared-memory ring on the paper's chunk schedule (`csrc/ring.cuh`;
G from `core.schedule.plan_matmul_sm90`).

`gpp_matmul_grouped`: y[e] = act((x[e] @ W[e]) * w_scale[e] + bias[e]) for
E experts — the port of `gpp_matmul_grouped`, the MoE layer's routed-expert
FFN.  Same tile kernel (`csrc/gpp_matmul_grouped.cu`), with each CTA walking
the k-steps of a few consecutive experts on one ring
(`core.schedule.plan_grouped_sm90`).

Both take CUDA tensors only and raise on anything the kernel cannot take;
their plain versions (`kernels.ref.dense_ref` / `dense_grouped_ref`) are
what `kernels.ops` runs on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.schedule import plan_grouped_sm90, plan_matmul_sm90
from repro_torch.kernels import build
from repro_torch.kernels.ref import ACTIVATION_IDS

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
W_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

launches = build.LaunchCounter()
launches_grouped = build.LaunchCounter()


def _lib(name: str, n_int: int) -> ctypes.CDLL:
    """Library `name` with its launch entry typed: five pointers, n_int
    ints, then the record and stream pointers."""
    lib = build.load(name)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = [p] * 5 + [i] * n_int + [p, p]
        launch.restype = i
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
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
    M, K = x.shape
    N = w.shape[1]
    _check_operands("gpp_matmul", x, w, record)
    scale = _epilogue_vector(w_scale, 1, N, x.device, "w_scale")
    b = _epilogue_vector(bias, 1, N, x.device, "bias", full=True)
    plan = plan_matmul_sm90(M, K, N, w_itemsize=w.element_size(),
                            num_bufs=num_bufs)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    vec = build.copy_width(N * w.element_size(), w.data_ptr())
    lib = _lib("gpp_matmul", 11)
    err = lib.gpp_matmul_launch(
        x.data_ptr(), w.data_ptr(), _ptr(scale), _ptr(b), y.data_ptr(),
        M, K, N, X_DTYPES[x.dtype], W_DTYPES[w.dtype], plan.block_m,
        plan.block_k, plan.num_bufs, plan.chunks, ACTIVATION_IDS[activation],
        vec, _ptr(record), torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "gpp_matmul")
    launches.n += 1
    return y


def _check_operands(what: str, x, w, record) -> None:
    """The device, dtype and layout checks both wrappers share: CUDA
    tensors only (there is no CPU kernel), on one device, contiguous."""
    if not x.is_cuda:
        raise ValueError(f"{what} launches a CUDA kernel and needs CUDA "
                         f"tensors, got x on {x.device} (the plain version "
                         "is kernels.ref; kernels.ops routes by device)")
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if x.dtype not in X_DTYPES or w.dtype not in W_DTYPES:
        raise TypeError(f"unsupported dtypes x {x.dtype}, w {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{what} needs contiguous x and w")
    if record is not None and (record.dtype != torch.int32
                               or record.device != x.device):
        raise ValueError("record must be an int32 tensor on the same device")


def _epilogue_vector(v, E: int, N: int, dev, name: str, full=False):
    """w_scale (scalar, (E,) or (E, N)) or bias ((E, N) only: `full`) as a
    contiguous f32 (E, N) tensor on `dev`, or None."""
    if v is None:
        return None
    if full and v.device != dev:
        raise ValueError(f"{name} on {v.device}, x on {dev}")
    t = torch.as_tensor(v, dtype=torch.float32, device=dev)
    n = t.numel()
    if n == E * N:
        t = t.reshape(E, N)
    elif not full and n == 1:
        t = t.reshape(1, 1).expand(E, N)
    elif not full and n == E:
        t = t.reshape(E, 1).expand(E, N)
    else:
        shapes = f"({E}, {N})" if full else f"a scalar, ({E},) or ({E}, {N})"
        raise ValueError(f"{name} must be {shapes}, got {tuple(t.shape)}")
    return t.contiguous()


def gpp_matmul_grouped(x: torch.Tensor, w: torch.Tensor, *,
                       bias: "torch.Tensor | None" = None, w_scale=None,
                       activation: "str | None" = None,
                       num_bufs: "int | None" = None,
                       record: "torch.Tensor | None" = None) -> torch.Tensor:
    """Batched-expert streaming matmul: y[e] = act(x[e] @ w[e] [* w_scale[e]]
    [+ bias[e]]).

    x: (E, M, K) f32/bf16; w: (E, K, N) f32/bf16/int8; bias: (E, N);
    w_scale: scalar, (E,) or (E, N).  Output (E, M, N) in x.dtype.
    num_bufs pins the ring depth G (None plans it); the experts one CTA
    walks on its ring are always planned.  record: optional int32 CUDA
    tensor for CTA (0, 0, 0)'s issue order (see `issue_order_grouped`).
    """
    if activation not in ACTIVATION_IDS:
        raise ValueError(f"unknown activation {activation!r}")
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"gpp_matmul_grouped wants (E,M,K) @ (E,K,N), got "
                         f"x{tuple(x.shape)} w{tuple(w.shape)}")
    E, M, K = x.shape
    N = w.shape[2]
    _check_operands("gpp_matmul_grouped", x, w, record)
    scale = _epilogue_vector(w_scale, E, N, x.device, "w_scale")
    b = _epilogue_vector(bias, E, N, x.device, "bias", full=True)
    plan = plan_grouped_sm90(E, M, K, N, w_itemsize=w.element_size(),
                             num_bufs=num_bufs)
    tp = plan.tile
    y = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    vec = build.copy_width(N * w.element_size(), w.data_ptr())
    lib = _lib("gpp_matmul_grouped", 13)
    err = lib.gpp_matmul_grouped_launch(
        x.data_ptr(), w.data_ptr(), _ptr(scale), _ptr(b), y.data_ptr(),
        E, M, K, N, plan.experts_per_cta, X_DTYPES[x.dtype],
        W_DTYPES[w.dtype], tp.block_m, tp.block_k, tp.num_bufs, tp.chunks,
        ACTIVATION_IDS[activation], vec, _ptr(record),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "gpp_matmul_grouped")
    launches_grouped.n += 1
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
    return _read_record(rec), num_k, plan.num_bufs, plan.chunks


def issue_order_grouped(x: torch.Tensor, w: torch.Tensor, num_bufs: int):
    """`issue_order` for `gpp_matmul_grouped`: CTA (0, 0, 0) walks the
    k-steps of the planned run of experts 0 .. experts_per_cta-1 as one run,
    so where the plan gives a CTA more than one expert the record crosses
    expert boundaries.  Returns ({(step, chunk): [issue_steps]}, num_steps,
    G, C, experts_per_cta); `chunk_issue_schedule(num_steps, G, C)` is the
    order it should equal."""
    E, M, K = x.shape
    plan = plan_grouped_sm90(E, M, K, w.shape[2], w_itemsize=w.element_size(),
                             num_bufs=num_bufs)
    tp = plan.tile
    steps = plan.experts_per_cta * tp.grid(M, w.shape[2], K)[2]
    rec = torch.full((3 * steps * tp.chunks,), -1, dtype=torch.int32,
                     device=x.device)
    gpp_matmul_grouped(x, w, num_bufs=num_bufs, record=rec)
    return (_read_record(rec), steps, tp.num_bufs, tp.chunks,
            plan.experts_per_cta)


def _read_record(rec: torch.Tensor) -> "dict[tuple[int, int], list[int]]":
    order: "dict[tuple[int, int], list[int]]" = {}
    for step, chunk, at in rec.view(-1, 3).tolist():
        if step >= 0:
            order.setdefault((step, chunk), []).append(at)
    return order
