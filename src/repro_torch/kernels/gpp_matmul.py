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
FFN.  One library (`csrc/gpp_matmul_grouped.cu`), two tile kernels, routed
by dtype (`grouped_route`):
  * "tc": bf16 x and bf16 W (the serving path) run
    `gpp_matmul_grouped_tc_kernel` — mma.sync tensor cores, persistent
    balanced CTAs on the same GPP ring (`core.schedule.plan_grouped_tc_sm90`);
  * "fma": f32 x, or f32 / int8 W, run `gpp_matmul_grouped_kernel`, the
    CUDA-core tile kernel of `gpp_matmul.cuh` with each CTA walking the
    k-steps of a few consecutive experts on one ring
    (`core.schedule.plan_grouped_sm90`).

Both take CUDA tensors only and raise on anything the kernel cannot take;
their plain versions (`kernels.ref.dense_ref` / `dense_grouped_ref`) are
what `kernels.ops` runs on the CPU.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.schedule import (plan_grouped_sm90,
                                      plan_grouped_tc_sm90, plan_matmul_sm90)
from repro_torch.kernels import build
from repro_torch.kernels.ref import ACTIVATION_IDS

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
W_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

launches = build.LaunchCounter()
launches_grouped = build.LaunchCounter()       # the FMA route
launches_grouped_tc = build.LaunchCounter()    # the tensor-core route


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


def grouped_route(x_dtype: torch.dtype, w_dtype: torch.dtype) -> str:
    """Which tile kernel `gpp_matmul_grouped` launches: "tc" (tensor cores)
    for bf16 x and bf16 W, "fma" (CUDA cores) for f32 x or f32 / int8 W."""
    if x_dtype == torch.bfloat16 and w_dtype == torch.bfloat16:
        return "tc"
    return "fma"


class _GroupedLaunch(NamedTuple):
    """One `gpp_matmul_grouped` launch on its route, as planned: the C
    entry's route, tile and ring arguments, and the first CTA's run."""

    route: int           # 0 the FMA kernel, 1 the tensor-core kernel
    block_m: int
    block_k: int
    num_bufs: int
    chunks: int
    grid: int            # tensor-core route: persistent CTAs
    experts_per_cta: int  # FMA route
    steps: int           # steps of the first CTA's run
    items: int           # its work items: units (tc) or experts (fma)


def _plan_grouped(x: torch.Tensor, w: torch.Tensor,
                  num_bufs: "int | None") -> _GroupedLaunch:
    E, M, K = x.shape
    N = w.shape[2]
    if grouped_route(x.dtype, w.dtype) == "tc":
        p = plan_grouped_tc_sm90(E, M, K, N, num_bufs=num_bufs)
        return _GroupedLaunch(1, p.block_m, p.block_k, p.num_bufs, p.chunks,
                              p.grid, 0, p.cta_steps(0), len(p.cta_units(0)))
    plan = plan_grouped_sm90(E, M, K, N, w_itemsize=w.element_size(),
                             num_bufs=num_bufs)
    tp, epc = plan.tile, plan.experts_per_cta
    return _GroupedLaunch(0, tp.block_m, tp.block_k, tp.num_bufs, tp.chunks,
                          0, epc, epc * tp.grid(M, N, K)[2], epc)


def gpp_matmul_grouped(x: torch.Tensor, w: torch.Tensor, *,
                       bias: "torch.Tensor | None" = None, w_scale=None,
                       activation: "str | None" = None,
                       num_bufs: "int | None" = None,
                       record: "torch.Tensor | None" = None) -> torch.Tensor:
    """Batched-expert streaming matmul: y[e] = act(x[e] @ w[e] [* w_scale[e]]
    [+ bias[e]]).

    x: (E, M, K) f32/bf16; w: (E, K, N) f32/bf16/int8; bias: (E, N);
    w_scale: scalar, (E,) or (E, N).  Output (E, M, N) in x.dtype.
    num_bufs pins the ring depth G (None plans it); tiles, and the work
    each CTA walks on its ring, are always planned.  bf16 x and w take the
    tensor-core kernel, anything else the FMA kernel (`grouped_route`).
    record: optional int32 CUDA tensor for the first CTA's issue order (see
    `issue_order_grouped`).
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
    p = _plan_grouped(x, w, num_bufs)
    y = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    lib = _lib("gpp_matmul_grouped", 16)
    err = lib.gpp_matmul_grouped_launch(
        x.data_ptr(), w.data_ptr(), _ptr(scale), _ptr(b), y.data_ptr(),
        E, M, K, N, p.experts_per_cta, X_DTYPES[x.dtype], W_DTYPES[w.dtype],
        p.block_m, p.block_k, p.num_bufs, p.chunks,
        ACTIVATION_IDS[activation],
        build.copy_width(N * w.element_size(), w.data_ptr()), p.route,
        p.grid, build.copy_width(K * x.element_size(), x.data_ptr()),
        _ptr(record), torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "gpp_matmul_grouped")
    (launches_grouped_tc if p.route else launches_grouped).n += 1
    return y


def grouped_tc_ctas_per_sm(plan) -> int:
    """CTAs of the tensor-core kernel an SM of this card holds at `plan`'s
    tile and ring (the occupancy the planner assumed is `ctas_per_sm`)."""
    lib = _lib("gpp_matmul_grouped", 16)
    fn = lib.gpp_matmul_grouped_tc_ctas_per_sm
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    n = fn(plan.block_m, plan.block_k, plan.num_bufs)
    if n < 0:
        build.check_launch(lib, -n, "gpp_matmul_grouped")
    return n


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
    return build.read_issue_record(rec), num_k, plan.num_bufs, plan.chunks


def issue_order_grouped(x: torch.Tensor, w: torch.Tensor, num_bufs: int):
    """`issue_order` for `gpp_matmul_grouped`, on the route x and w take.
    The first CTA walks its run of work as one run of steps: on the
    tensor-core route its units (`plan_grouped_tc_sm90(...).cta_units(0)`,
    (expert, n-tile, m-tile) each), on the FMA route experts 0 ..
    experts_per_cta-1 at one tile position.  Returns ({(step, chunk):
    [issue_steps]}, num_steps, G, C, work items in the run);
    `chunk_issue_schedule(num_steps, G, C)` is the order it should equal."""
    p = _plan_grouped(x, w, num_bufs)
    rec = torch.full((3 * p.steps * p.chunks,), -1, dtype=torch.int32,
                     device=x.device)
    gpp_matmul_grouped(x, w, num_bufs=num_bufs, record=rec)
    return (build.read_issue_record(rec), p.steps, p.num_bufs, p.chunks,
            p.items)
