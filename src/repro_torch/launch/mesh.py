"""Device meshes over `torch.distributed` (the port's copy of
`repro.launch.mesh`).

Functions, not module-level constants, so importing this module starts no
process group.  A mesh is a `torch.distributed.device_mesh.DeviceMesh`
with named dims; its `get_group(name)` is the process group of one axis
(the streamer's FSDP group, `core.streamer`).  The caller starts the
process group first (`torch.distributed.init_process_group` with its
address, world size and rank).  More than one rank runs on gloo over CPU
processes here; NCCL over several cards comes with the sharded steps
(ROADMAP §1.8b).  The reference's `make_mesh_compat` / `mesh_context`
paper over JAX versions and have no counterpart.
"""
from __future__ import annotations


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
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (16, 16) ("data", "model") = 256 cards.  Multi-pod:
    (2, 16, 16) ("pod", "data", "model") = 512.  On CUDA (NCCL)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh("cuda", shape, names)


def make_host_mesh(data: int = 2, model: int = 2):
    """A small ("data", "model") mesh over CPU ranks (gloo), for tests and
    examples."""
    return _mesh("cpu", (data, model), ("data", "model"))


def dp_axes(mesh) -> "tuple[str, ...]":
    """Batch-sharding axes of the mesh."""
    from repro_torch.dist.sharding import axis_sizes
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))
