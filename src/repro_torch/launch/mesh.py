"""Device meshes over `torch.distributed` (the port's copy of
`repro.launch.mesh`), and the one helper that starts N ranks.

Functions, not module-level constants, so importing this module starts no
process group.  A mesh is a `torch.distributed.device_mesh.DeviceMesh`
with named dims; its `get_group(name)` is the process group of one axis.
The caller starts the process group first (`init_rank`, or
`torch.distributed.init_process_group` with its address, world size and
rank): nothing on a machine tells a program of a cluster.

  make_cuda_mesh   one rank a card over NCCL; on one H100 it is 1x1
  make_host_mesh   CPU ranks over gloo (tests, the CLI's --device cpu),
                   with a "pod" axis too when asked
  fake_mesh        any shape over a fake process group, this process its
                   rank 0: the dry run's 256- and 512-card meshes, on meta
  spawn_ranks      start N ranks that meet at a file store, each running
                   fn(rank, world, *args) inside its process group

There is no fallback: a CUDA mesh with more ranks than cards raises, and
so does NCCL without CUDA.  The reference's `make_mesh_compat` /
`mesh_context` paper over JAX versions and have no counterpart.
"""
from __future__ import annotations

import contextlib


def _mesh(device_type: str, shape: "tuple[int, ...]",
          names: "tuple[str, ...]"):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs a process group of "
            f"{n} ranks (torch.distributed.init_process_group); have "
            f"{have}")
    if device_type == "cuda":
        _check_cuda(n)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def _check_cuda(n: int) -> None:
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs CUDA (NCCL)")
    if n > torch.cuda.device_count():
        raise RuntimeError(f"a CUDA mesh of {n} ranks needs {n} cards; "
                           f"have {torch.cuda.device_count()}")
    if dist.is_initialized() and dist.get_backend() != "nccl":
        raise RuntimeError(f"a CUDA mesh runs over NCCL, not "
                           f"{dist.get_backend()}")


def make_cuda_mesh(data: int = 1, model: int = 1):
    """A ("data", "model") mesh of one rank a card, over NCCL."""
    return _mesh("cuda", (data, model), ("data", "model"))


def production_layout(multi_pod: bool = False):
    """(shape, dim names) of the production meshes: single pod (16, 16)
    ("data", "model") = 256 cards, multi-pod (2, 16, 16) ("pod", "data",
    "model") = 512."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh (`production_layout`) on CUDA (NCCL)."""
    return _mesh("cuda", *production_layout(multi_pod))


@contextlib.contextmanager
def fake_mesh(shape: "tuple[int, ...]", names: "tuple[str, ...]"):
    """A CPU DeviceMesh of `shape` over a fake process group in which this
    process is rank 0 of prod(shape): the dry run's stand-in for the
    reference's `--xla_force_host_platform_device_count=512`.  The fake
    group's collectives return at once and leave their outputs unfilled,
    so run only meta tensors through it (shapes are all it gives).  It
    becomes this process's default group for the block: raises if a
    process group is up already, and destroys its own on the way out."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is up already; the fake mesh "
                           "needs a process of its own")
    n = 1
    for s in shape:
        n *= s
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield _mesh("cpu", tuple(shape), tuple(names))
    finally:
        dist.destroy_process_group()


def make_host_mesh(data: int = 2, model: int = 2, pod: int = 0):
    """A small ("data", "model") mesh over CPU ranks (gloo), for tests and
    examples; with `pod`, a ("pod", "data", "model") one, the multi-pod
    mesh's layout."""
    if pod:
        return _mesh("cpu", (pod, data, model), ("pod", "data", "model"))
    return _mesh("cpu", (data, model), ("data", "model"))


def dp_axes(mesh) -> "tuple[str, ...]":
    """Batch-sharding axes of the mesh."""
    from repro_torch.dist.sharding import axis_sizes
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


# ---------------------------------------------------------------------------
# starting ranks
# ---------------------------------------------------------------------------

def init_rank(rank: int, world: int, store: str,
              backend: str = "gloo") -> None:
    """Join the process group of `world` ranks that meet at the file
    `store` (a `FileStore`: no port to race other processes for, and
    gloo's own connections take theirs from the system); an NCCL rank
    takes card `rank`.  The file's directory must outlive the group."""
    import torch
    import torch.distributed as dist
    if backend == "nccl":
        _check_cuda(world)
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)


def _rank_main(rank, fn, world, store, backend, threads, args):
    import torch
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    init_rank(rank, world, store, backend)
    try:
        fn(rank, world, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, backend: str = "gloo",
                threads: int = 1) -> None:
    """Run fn(rank, world, *args) in `world` new processes, each inside a
    process group of `backend` that meets at a file store in a new
    temporary directory (gloo ranks take `threads` CPU threads each).
    gloo ranks fork from the caller, which saves each of them a second
    import of torch; NCCL ranks are spawned, as CUDA does not survive a
    fork, so there `fn` must be importable (a module-level function).
    Raises when a rank fails."""
    import os
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(
            _rank_main, args=(fn, world, os.path.join(d, "store"), backend,
                              threads, args),
            nprocs=world, join=True,
            start_method="fork" if backend == "gloo" else "spawn")
