"""Device selection for the port's entry points: CUDA unless asked for CPU."""
from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device an entry point runs on.

    `cuda` (the default) requires a CUDA device and raises otherwise; the
    CPU is used only when the caller names it.  There is no silent fallback
    from the card to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
                "to run the plain PyTorch path on the CPU")
        # full-precision f32 products everywhere (the reference's numerics)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
