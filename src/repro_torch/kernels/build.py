"""Build and load the CUDA kernels: nvcc into shared libraries, ctypes.

Each `csrc/<name>.cu` compiles on its own (plain C interface, no PyTorch
headers) with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

at first CUDA use, into `kernels/_build/` (listed in .gitignore).  The hash
covers the sources and flags, so an edited kernel rebuilds and an unchanged
one is reused.  `build_all` starts one nvcc per source at once.  A missing
nvcc or a failed build raises; nothing falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = ("gpp_matmul", "paged_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: "dict[str, ctypes.CDLL]" = {}


class LaunchCounter:
    """Plain count of a kernel's launches (the wrapper adds one per launch);
    a run sets `n` to 0 before the path it reads it after."""

    def __init__(self) -> None:
        self.n = 0


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use and need the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh") and (src.stem == name
                                              or src.suffix == ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: "tuple[str, ...]" = KERNELS) -> "dict[str, float]":
    """Compile every library in `names` that is not built yet, one nvcc per
    source, all started together.  Returns seconds per library built."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds = {}
    failed = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        seconds[n] = time.perf_counter() - t0
        if p.returncode != 0:
            failed.append(f"{n}: nvcc exited {p.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib


def copy_width(row_bytes: int, *ptrs: int) -> int:
    """Widest cp.async copy (16, 8 or 4 bytes) dividing a row and every
    base address; 1 selects the kernels' synchronous byte-copy path."""
    for v in (16, 8, 4):
        if row_bytes % v == 0 and all(p % v == 0 for p in ptrs):
            return v
    return 1


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = getattr(lib, f"{what}_error_string")(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err})")
