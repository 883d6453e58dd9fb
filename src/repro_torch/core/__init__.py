"""Generalized ping-pong (GPP) — the paper's contribution, the port's copy.

Layers:
  analytical     closed-form model (paper Eqs 1-9)
  schedule       schedule IR + in-situ / naive ping-pong / GPP builders, the
                 stream / serve planners, `TimingCache`, and the sm_90
                 plans of the CUDA kernels
  simulator      cycle-accurate discrete-event simulation (Verilog stand-in)
  dse            design-phase exploration (Fig 6, Table II)
  runtime_adapt  runtime bandwidth adaptation (Fig 7)
  streamer       the four strategies at layer scale: `stream_layers` runs
                 a model's stacked layers resident, in situ, naive
                 ping-pong or GPP, fetching them from FSDP shards or host
                 memory
"""
from repro_torch.core.analytical import PimConfig, STRATEGIES
from repro_torch.core.schedule import (Schedule, ScheduleOp, StreamPlan,
                                       build, plan_stream)
from repro_torch.core.simulator import SimResult, simulate

__all__ = [
    "PimConfig",
    "STRATEGIES",
    "Schedule",
    "ScheduleOp",
    "StreamPlan",
    "build",
    "plan_stream",
    "SimResult",
    "simulate",
]
