"""`gpp_matmul` and `gpp_matmul_grouped`: the generalized ping-pong
streaming matmuls on the H100.

`gpp_matmul`: y[M, N] = act((x[M, K] @ W[K, N]) * w_scale + bias) with f32
accumulation — the port of `repro/kernels/gpp_matmul.py::gpp_matmul`.  One
library (`csrc/gpp_matmul.cu`), two kernels, routed by dtype
(`gpp_route`):
  * "tc": bf16 x and bf16 W (every projection of both serving paths but
    deepseek's f32 router) run `gpp_matmul_tc_kernel` — mma.sync tensor
    cores, cluster split-K: each output tile is one thread-block cluster
    whose CTAs walk contiguous k-slices on one GPP ring each, and the
    partials are summed in rank order through distributed shared memory
    (`core.schedule.plan_matmul_tc_sm90`); no workspace, no counters;
  * "fma": f32 x, or f32 / int8 W, run `gpp_matmul_kernel` — f32 FMA on
    the CUDA cores, split-K: persistent CTAs each walking a balanced run
    of (64-column tile, k-step) units on one GPP ring, split tiles summed
    in a fixed order by their last CTA through a global workspace and
    per-tile arrival counters (`_tile_counters`, this route's alone;
    `core.schedule.plan_matmul_fma_sm90`), the body of `csrc/gpp_matmul.cuh`
    at E = 1.
On both routes the split comes from K and N alone, so a row's bits do not
depend on M.

`gpp_matmul_grouped`: y[e] = act((x[e] @ W[e]) * w_scale[e] + bias[e]) for
E experts — the port of `gpp_matmul_grouped`, the MoE layer's routed-expert
FFN.  One library (`csrc/gpp_matmul_grouped.cu`), two tile kernels, routed
by dtype (`grouped_route`):
  * "tc": bf16 x and bf16 W (the serving path) run
    `gpp_matmul_grouped_tc_kernel` — mma.sync tensor cores, persistent
    balanced CTAs on the same GPP ring (`core.schedule.plan_grouped_tc_sm90`);
  * "fma": f32 x, or f32 / int8 W, run `gpp_matmul_grouped_kernel`, the
    same split-K FMA body over the expert axis: units (m-tile, expert,
    n-tile, k-step), runs across expert boundaries on one ring
    (`core.schedule.plan_matmul_fma_sm90` with E).

Both take CUDA tensors only and raise on anything the kernel cannot take;
their plain versions (`kernels.ref.dense_ref` / `dense_grouped_ref`) are
what `kernels.ops` runs on the CPU.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.schedule import (GroupedTcPlan, MatmulFmaPlan,
                                      MatmulTcClusterPlan,
                                      plan_grouped_tc_sm90,
                                      plan_matmul_fma_sm90,
                                      plan_matmul_tc_sm90)
from repro_torch.kernels import build
from repro_torch.kernels.ref import ACTIVATION_IDS, chunk_issue_schedule

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
W_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

launches = build.LaunchCounter()               # the FMA route
launches_tc = build.LaunchCounter()            # the tensor-core route
launches_grouped = build.LaunchCounter()       # the FMA route
launches_grouped_tc = build.LaunchCounter()    # the tensor-core route


def _lib(name: str, n_ptr: int, n_int: int) -> ctypes.CDLL:
    """Library `name` with its launch entry typed: n_ptr pointers, n_int
    ints, then the record and stream pointers."""
    lib = build.load(name)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = [p] * n_ptr + [i] * n_int + [p, p]
        launch.restype = i
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [i]
        err.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _ptr(t: "torch.Tensor | None"):
    return None if t is None else t.data_ptr()


def gpp_route(x_dtype: torch.dtype, w_dtype: torch.dtype) -> str:
    """Which tile kernel `gpp_matmul` launches: "tc" (tensor cores) for
    bf16 x and bf16 W, "fma" (CUDA cores) for f32 x or f32 / int8 W."""
    if x_dtype == torch.bfloat16 and w_dtype == torch.bfloat16:
        return "tc"
    return "fma"


def gpp_matmul(x: torch.Tensor, w: torch.Tensor, *,
               bias: "torch.Tensor | None" = None, w_scale=None,
               activation: "str | None" = None,
               num_bufs: "int | None" = None,
               record: "torch.Tensor | None" = None,
               route: "str | None" = None) -> torch.Tensor:
    """Streaming matmul with the generalized ping-pong shared-memory ring.

    x: (M, K) f32/bf16; w: (K, N) f32/bf16/int8 (copied raw, widened on
    chip); bias: (N,); w_scale: scalar or (N,) dequant scale applied to the
    f32 accumulator; activation: none | relu | gelu (tanh) | silu | tanh |
    sigmoid.  Output in x.dtype.  num_bufs pins the ring depth G (1 in-situ,
    2 naive ping-pong, >= 3 GPP); None plans it.  bf16 x and w take the
    tensor-core kernel, anything else the FMA kernel (`gpp_route`); `route`
    ("fma" or "tc") pins one, for tests and sweeps.  record: optional int32
    CUDA tensor that receives the first CTA's (step, chunk, issue_step)
    triples (see `issue_order`).  A launch the card refuses (a cluster it
    cannot place, say) raises.
    """
    if activation not in ACTIVATION_IDS:
        raise ValueError(f"unknown activation {activation!r}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"gpp_matmul wants (M,K) @ (K,N), got "
                         f"x{tuple(x.shape)} w{tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    _check_operands("gpp_matmul", x, w, record)
    r = gpp_route(x.dtype, w.dtype) if route is None else route
    if r not in ("fma", "tc"):
        raise ValueError(f"route is 'fma' or 'tc', got {route!r}")
    if r == "tc" and gpp_route(x.dtype, w.dtype) != "tc":
        raise TypeError(f"the tensor-core route takes bf16 x and W, got "
                        f"x {x.dtype}, w {w.dtype}")
    scale = _epilogue_vector(w_scale, 1, N, x.device, "w_scale")
    b = _epilogue_vector(bias, 1, N, x.device, "bias", full=True)
    return _launch(x, w, _plan(r, M, K, N, w.element_size(), num_bufs),
                   scale, b, activation, record, r)


# each shape is planned once a process (the FMA plan's `max_segs` walks
# its tiles)
_tc_plan = functools.lru_cache(maxsize=256)(plan_matmul_tc_sm90)
_fma_plan = functools.lru_cache(maxsize=256)(plan_matmul_fma_sm90)


def _plan(route: str, M: int, K: int, N: int, w_itemsize: int,
          num_bufs: "int | None", **pins
          ) -> "MatmulTcClusterPlan | MatmulFmaPlan":
    """The cached plan of one launch on `route`; `pins` go to its planner
    (tc: block_n, cluster, block_k; fma: block_k, grid)."""
    if route == "tc":
        return _tc_plan(M, K, N, num_bufs=num_bufs, **pins)
    return _fma_plan(M, K, N, w_itemsize=w_itemsize, num_bufs=num_bufs,
                     **pins)


# arrival counters of the FMA route's split tiles, one int a tile, zero
# between launches (each launch's last CTA on a tile resets its counter).
# Launches on one stream run in order, so each stream keeps its own
# buffer; a launch captured into a CUDA graph takes one of its own, zeroed
# at each replay, so a replay never shares counters with eager launches on
# any stream.  (The tensor-core route sums its splits in shared memory and
# needs none.)
_COUNTERS: "dict[tuple[torch.device, int], torch.Tensor]" = {}


def _tile_counters(dev: torch.device, stream, tiles: int) -> torch.Tensor:
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros(tiles, dtype=torch.int32, device=dev)
    key = (dev, stream.cuda_stream)
    c = _COUNTERS.get(key)
    if c is None or c.numel() < tiles:
        c = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[key] = c
    return c


def _fma_scratch(plan: MatmulFmaPlan, x: torch.Tensor, stream):
    """The FMA route's f32 workspace (torch.empty from the caching
    allocator: every slot is written before it is read) and the stream's
    tile counters, or (None, None) when the plan splits no tile."""
    if plan.max_segs == 1:
        return None, None
    ws = torch.empty(plan.workspace_floats, dtype=torch.float32,
                     device=x.device)
    return ws, _tile_counters(x.device, stream, plan.tiles)


def _launch(x: torch.Tensor, w: torch.Tensor,
            plan: "MatmulTcClusterPlan | MatmulFmaPlan", scale, b,
            activation: "str | None", record: "torch.Tensor | None",
            route: str) -> torch.Tensor:
    """Launch `route`'s kernel on its plan ("tc": `gpp_matmul_tc_kernel`,
    `_launch_tc`; "fma": `gpp_matmul_kernel`).  The FMA route's split
    tiles' f32 partials go to a workspace (`_fma_scratch`).  Nothing
    syncs."""
    if route == "tc":
        return _launch_tc(x, w, plan, scale, b, activation, record)
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device)
    ws, cnt = _fma_scratch(plan, x, stream)
    lib = _lib("gpp_matmul", 7, 14)
    err = lib.gpp_matmul_launch(
        x.data_ptr(), w.data_ptr(), _ptr(scale), _ptr(b), y.data_ptr(),
        _ptr(ws), _ptr(cnt), M, K, N, X_DTYPES[x.dtype], W_DTYPES[w.dtype],
        plan.block_m, plan.block_k, plan.num_bufs, plan.chunks,
        ACTIVATION_IDS[activation],
        build.copy_width(N * w.element_size(), w.data_ptr()), plan.grid,
        plan.max_segs, build.copy_width(K * x.element_size(), x.data_ptr()),
        _ptr(record), stream.cuda_stream)
    build.check_launch(lib, err, "gpp_matmul")
    launches.n += 1
    return y


def _tc_lib() -> ctypes.CDLL:
    """The gpp_matmul library with its tensor-core entries typed."""
    lib = _lib("gpp_matmul", 7, 14)
    if not getattr(lib, "_tc_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gpp_matmul_tc_launch.argtypes = [p] * 5 + [i] * 12 + [p, p]
        lib.gpp_matmul_tc_launch.restype = i
        lib.gpp_matmul_tc_max_clusters.argtypes = [i] * 6
        lib.gpp_matmul_tc_max_clusters.restype = i
        lib._tc_typed = True
    return lib


def _launch_tc(x: torch.Tensor, w: torch.Tensor, plan: MatmulTcClusterPlan,
               scale, b, activation: "str | None",
               record: "torch.Tensor | None") -> torch.Tensor:
    """Launch `gpp_matmul_tc_kernel` on `plan`: grid (cluster, n_tiles,
    m_tiles) in clusters of `plan.cluster` CTAs.  It allocates only y, and
    nothing syncs."""
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    lib = _tc_lib()
    err = lib.gpp_matmul_tc_launch(
        x.data_ptr(), w.data_ptr(), _ptr(scale), _ptr(b), y.data_ptr(),
        M, K, N, plan.block_m, plan.block_n, plan.block_k, plan.num_bufs,
        plan.chunks, plan.cluster, ACTIVATION_IDS[activation],
        build.copy_width(N * 2, w.data_ptr()),
        build.copy_width(K * 2, x.data_ptr()), _ptr(record),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "gpp_matmul")
    launches_tc.n += 1
    return y


def tc_max_clusters(plan: MatmulTcClusterPlan) -> int:
    """Clusters of `plan`'s shape (cluster size, tile, ring, shared memory,
    and the kernel instance its rows' copy width picks) that this card
    holds at once (cudaOccupancyMaxActiveClusters): the plan's `tiles`
    clusters all run in one wave when it is at least that."""
    lib = _tc_lib()
    vec = 16 if plan.K % 8 == 0 and plan.N % 8 == 0 else 1
    n = lib.gpp_matmul_tc_max_clusters(plan.block_m, plan.block_n,
                                       plan.block_k, plan.num_bufs,
                                       plan.cluster, vec)
    if n < 0:
        build.check_launch(lib, -n, "gpp_matmul")
    return n


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


def _plan_grouped(x: torch.Tensor, w: torch.Tensor, num_bufs: "int | None"
                  ) -> "GroupedTcPlan | MatmulFmaPlan":
    """The plan of one `gpp_matmul_grouped` launch on the route x and w
    take: `plan_grouped_tc_sm90` (tensor cores) or `plan_matmul_fma_sm90`
    with E experts (FMA)."""
    E, M, K = x.shape
    N = w.shape[2]
    if grouped_route(x.dtype, w.dtype) == "tc":
        return plan_grouped_tc_sm90(E, M, K, N, num_bufs=num_bufs)
    return _fma_plan(M, K, N, w_itemsize=w.element_size(), E=E,
                     num_bufs=num_bufs)


def gpp_matmul_grouped(x: torch.Tensor, w: torch.Tensor, *,
                       bias: "torch.Tensor | None" = None, w_scale=None,
                       activation: "str | None" = None,
                       num_bufs: "int | None" = None,
                       record: "torch.Tensor | None" = None) -> torch.Tensor:
    """Batched-expert streaming matmul: y[e] = act(x[e] @ w[e] [* w_scale[e]]
    [+ bias[e]]).

    x: (E, M, K) f32/bf16; w: (E, K, N) f32/bf16/int8; bias: (E, N);
    w_scale: scalar, (E,) or (E, N).  Output (E, M, N) in x.dtype.
    num_bufs pins the ring depth G (None plans it); the rest of the plan is
    planned.  bf16 x and w take the tensor-core kernel, anything else the
    FMA kernel (`grouped_route`).  record: optional int32 CUDA tensor for
    the first CTA's issue order (see `issue_order_grouped`).
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
    return _launch_grouped(x, w, _plan_grouped(x, w, num_bufs), scale, b,
                           activation, record)


def _launch_grouped(x: torch.Tensor, w: torch.Tensor,
                    p: "GroupedTcPlan | MatmulFmaPlan", scale, b,
                    activation: "str | None",
                    record: "torch.Tensor | None") -> torch.Tensor:
    """Launch `gpp_matmul_grouped`'s kernel on plan `p`: the tensor-core
    kernel on a `GroupedTcPlan`, the FMA kernel (its workspace from
    `_fma_scratch`) on a `MatmulFmaPlan`.  Nothing syncs."""
    E, M, K = x.shape
    N = w.shape[2]
    tc = isinstance(p, GroupedTcPlan)
    y = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device)
    ws, cnt = (None, None) if tc else _fma_scratch(p, x, stream)
    lib = _lib("gpp_matmul_grouped", 7, 16)
    err = lib.gpp_matmul_grouped_launch(
        x.data_ptr(), w.data_ptr(), _ptr(scale), _ptr(b), y.data_ptr(),
        _ptr(ws), _ptr(cnt), E, M, K, N, X_DTYPES[x.dtype],
        W_DTYPES[w.dtype], p.block_m, p.block_k, p.num_bufs, p.chunks,
        ACTIVATION_IDS[activation],
        build.copy_width(N * w.element_size(), w.data_ptr()), int(tc),
        p.grid, build.copy_width(K * x.element_size(), x.data_ptr()),
        1 if tc else p.max_segs, _ptr(record), stream.cuda_stream)
    build.check_launch(lib, err, "gpp_matmul_grouped")
    (launches_grouped_tc if tc else launches_grouped).n += 1
    return y


def grouped_tc_ctas_per_sm(plan) -> int:
    """CTAs of the tensor-core kernel an SM of this card holds at `plan`'s
    tile and ring (the occupancy the planner assumed is `ctas_per_sm`)."""
    lib = _lib("gpp_matmul_grouped", 7, 16)
    fn = lib.gpp_matmul_grouped_tc_ctas_per_sm
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    n = fn(plan.block_m, plan.block_k, plan.num_bufs)
    if n < 0:
        build.check_launch(lib, -n, "gpp_matmul_grouped")
    return n


def fma_ctas_per_sm(plan: MatmulFmaPlan, x_dtype: torch.dtype,
                    w_dtype: torch.dtype) -> int:
    """CTAs of the FMA kernel (`gpp_matmul.cuh`, as the grouped library
    builds it) an SM of this card holds at `plan`'s tile and ring, for x
    and W of these dtypes (the planner assumed `ctas_per_sm`)."""
    lib = _lib("gpp_matmul_grouped", 7, 16)
    fn = lib.gpp_matmul_grouped_fma_ctas_per_sm
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    n = fn(X_DTYPES[x_dtype], W_DTYPES[w_dtype], plan.block_m, plan.block_k,
           plan.num_bufs)
    if n < 0:
        build.check_launch(lib, -n, "gpp_matmul_grouped")
    return n


def issue_order(x: torch.Tensor, w: torch.Tensor, num_bufs: "int | None",
                *, route: "str | None" = None, **pins):
    """Run one launch with the issue-order record on and return
    ({(step, chunk): [issue_steps]}, steps, G, C) for the first CTA — the
    structure `kernels.ref.chunk_issue_schedule(steps, G, C)` returns.  On
    the tensor-core route that CTA is rank 0 of tile 0's cluster, walking
    its k-slice (`plan_matmul_tc_sm90(...).k_slice(0)`; `block_n`,
    `cluster` and `block_k` pins shape it); on the FMA route CTA 0 walks
    its run of units (`plan_matmul_fma_sm90(...).cta_units(0)`) across tile
    and k-split boundaries (a `grid` pin makes it cross them)."""
    M, K = x.shape
    N = w.shape[1]
    r = gpp_route(x.dtype, w.dtype) if route is None else route
    plan = _plan(r, M, K, N, w.element_size(), num_bufs, **pins)
    steps, G, C = plan.cta_steps(0), plan.num_bufs, plan.chunks
    rec = torch.full((3 * steps * C,), -1, dtype=torch.int32,
                     device=x.device)
    _check_operands("gpp_matmul", x, w, rec)
    _launch(x, w, plan, None, None, None, rec, r)
    return build.read_issue_record(rec), steps, G, C


def issue_order_grouped(x: torch.Tensor, w: torch.Tensor,
                        num_bufs: "int | None"):
    """`issue_order` for `gpp_matmul_grouped`, on the route x and w take.
    The first CTA walks its run of work as one run of steps: on the
    tensor-core route its units (`plan_grouped_tc_sm90(...).cta_units(0)`,
    (expert, n-tile, m-tile) each), on the FMA route its (tile, k-step)
    units (`plan_matmul_fma_sm90(..., E=E).cta_units(0)`) across k-split,
    tile and expert boundaries.  Returns
    ({(step, chunk): [issue_steps]}, num_steps, G, C, work items in the
    run: units (tc) or tiles (fma), experts in the run);
    `chunk_issue_schedule(num_steps, G, C)` is the order it should
    equal."""
    p = _plan_grouped(x, w, num_bufs)
    if isinstance(p, GroupedTcPlan):
        items = [p.unit(u) for u in p.cta_units(0)]
        experts = {e for e, _, _ in items}
    else:
        items = sorted({p.unit(u)[0] for u in p.cta_units(0)})
        experts = {p.expert(t) for t in items}
    steps = p.cta_steps(0)
    rec = torch.full((3 * steps * p.chunks,), -1, dtype=torch.int32,
                     device=x.device)
    gpp_matmul_grouped(x, w, num_bufs=num_bufs, record=rec)
    return (build.read_issue_record(rec), steps, p.num_bufs, p.chunks,
            len(items), len(experts))


# ---------------------------------------------------------------------------
# trace lanes: host-side replays of the chunk schedule (obs)
# ---------------------------------------------------------------------------

def schedule_lane_events(trace, *, num_steps: int, G: int, C: int,
                         t0_us: float, dur_us: float, step_bytes: float = 0.0,
                         live=None, pid: int = 0, tid_dma: int = 0,
                         tid_compute: int = 1, max_events: int = 256,
                         name: str = "gpp") -> int:
    """Render the chunk-issue schedule as copy-vs-compute trace lanes (the
    reference's `schedule_lane_events`).

    Replays `chunk_issue_schedule(num_steps, G, C)` — the issue pattern a
    kernel's ring (`csrc/ring.cuh`) follows — and emits two lanes of
    Chrome trace-event "X" spans into `trace` (an `obs.trace.
    TraceRecorder`), scaled into the measured call window [t0_us, t0_us +
    dur_us]:

      tid_dma      chunk copies *started* per step (count + bytes)
      tid_compute  the step's compute occupancy

    The window is split evenly across LIVE steps (`live(s)` false: the
    kernel skips the step); the kernel has no per-step clock the host can
    read without a device sync, so these lanes are a schedule-exact model
    stretched over the host's wall window, cat="modeled".  Steps coalesce
    into at most `max_events` buckets per lane.  Returns the events
    emitted."""
    if not getattr(trace, "enabled", False) or num_steps <= 0 or dur_us <= 0:
        return 0
    sched = chunk_issue_schedule(num_steps, G, C)
    starts = [0] * num_steps            # chunk copies issued at each step
    for (step, chunk), at in sched.items():
        if live is None or live(step):
            for s in at:
                starts[s] += 1
    is_live = [bool(live(s)) if live is not None else True
               for s in range(num_steps)]
    n_live = sum(is_live)
    if n_live == 0:
        return 0
    dt = dur_us / n_live
    chunk_bytes = step_bytes / C if C else 0.0
    bucket = max(1, -(-num_steps // max_events))
    emitted = 0
    t = t0_us                           # start of the current bucket
    for b0 in range(0, num_steps, bucket):
        b1 = min(b0 + bucket, num_steps)
        live_in = sum(is_live[b0:b1])
        chunks = sum(starts[b0:b1])
        width = live_in * dt
        label = (f"{name} step {b0}" if bucket == 1
                 else f"{name} steps {b0}-{b1 - 1}")
        if chunks:
            trace.complete(
                f"{label} dma", t, width or dt * 0.1, pid=pid, tid=tid_dma,
                cat="modeled",
                args={"chunks_started": chunks,
                      "bytes": chunks * chunk_bytes, "ring": G})
            emitted += 1
        if live_in:
            trace.complete(
                f"{label} compute", t, width, pid=pid, tid=tid_compute,
                cat="modeled",
                args={"grid_steps": b1 - b0, "live_steps": live_in})
            emitted += 1
        t += width
    return emitted


def matmul_lane_events(trace, M: int, K: int, N: int, *,
                       itemsize: int = 4, t0_us: float, dur_us: float,
                       pid: int = 0, max_events: int = 256) -> int:
    """Schedule-exact copy/compute lanes for one `gpp_matmul(M, K, N)`
    call, from the port's own sm_90 plan (what the card runs, not the
    TPU's tiles): bf16 (itemsize 2) the tensor-core route's
    `plan_matmul_tc_sm90`, else the FMA route's `plan_matmul_fma_sm90`.
    Every CTA runs its own ring in parallel, so the lanes replay one CTA's
    run, CTA 0's (rank 0 of the first tile's cluster on the tensor-core
    route), over the measured window."""
    if itemsize == 2:
        plan = plan_matmul_tc_sm90(M, K, N)
    else:
        plan = plan_matmul_fma_sm90(M, K, N, w_itemsize=itemsize)
    steps = plan.cta_steps(0)
    G = min(plan.num_bufs, max(1, steps))
    return schedule_lane_events(
        trace, num_steps=steps, G=G, C=max(1, min(G - 1, plan.block_k)),
        t0_us=t0_us, dur_us=dur_us,
        step_bytes=plan.block_k * plan.block_n * itemsize,
        pid=pid, max_events=max_events, name="matmul")
