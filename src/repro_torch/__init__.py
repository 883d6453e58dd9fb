"""PyTorch + CUDA port of the generalized ping-pong (GPP) serving system.

The package mirrors `repro` module by module (same module and public
function names) and runs on an NVIDIA H100: every weight projection goes
through the hand-written CUDA `gpp_matmul` kernel and every paged KV read
through the hand-written CUDA paged-attention kernel, both streaming their
tiles through a G-slot shared-memory ring on the paper's chunk schedule.

It imports torch, numpy and the standard library only.  Entry points run on
`cuda` unless the caller passes `device="cpu"`, and raise when CUDA is
missing and the CPU was not asked for (`repro_torch.device`).
"""
