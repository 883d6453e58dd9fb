"""Unified telemetry for the serving stack: trace + ledger + metrics (a copy
of `repro.obs`).

Three pillars, one handle:

  `obs.trace`    span/event recorder -> Chrome/Perfetto trace-event JSON
                 (`obs/trace.py`): request lifecycles, engine step phases,
                 modeled kernel DMA-vs-compute lanes.
  `obs.ledger`   typed per-step HBM-byte ledger (`obs/ledger.py`): THE
                 step-metrics schema both engines emit, with bounded
                 retention and a simulate_gpp predicted-vs-measured
                 utilization column.  (The ledger is owned by the engine
                 as `engine.metrics`; `Telemetry` carries the trace and
                 the latency side.)
  `obs.registry` counters/gauges/histograms + per-request TTFT/TPOT via
                 `obs.requests` (`obs/metrics.py`), exported as JSONL.

`Telemetry.disabled()` is the default: `NULL_TRACE` plus a no-op request
tracker, so every instrumentation site in the hot path costs one attribute
check (`if obs.enabled:` around anything heavier than a method call).  The
enabled path adds host time only: spans read the host clock, never the
device (no synchronisation, no device read); its cost is measured on the
card by `chip_smoke.py` (obs on against off, target under 5% tokens/sec).
"""
from __future__ import annotations

import time

from repro_torch.obs.ledger import STEP_SCHEMA, BandwidthLedger, step_row
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, RequestTracker,
                                     percentile)
from repro_torch.obs.trace import (NULL_TRACE, PID_KERNEL, PID_REQUESTS,
                                   PID_SERVING, TID_COMPUTE, TID_DMA,
                                   TID_ENGINE, TID_LANE0, TraceRecorder,
                                   annotate_serving_tracks)

__all__ = [
    "STEP_SCHEMA", "BandwidthLedger", "step_row",
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "RequestTracker",
    "percentile",
    "NULL_TRACE", "TraceRecorder", "annotate_serving_tracks",
    "PID_SERVING", "PID_REQUESTS", "PID_KERNEL",
    "TID_ENGINE", "TID_LANE0", "TID_DMA", "TID_COMPUTE",
    "Telemetry", "make_telemetry",
]


class _NullRequests:
    """Disabled-path RequestTracker: lifecycle callbacks are free."""

    def on_submit(self, rid):
        pass

    def on_first_token(self, rid):
        pass

    def on_finish(self, rid, tokens):
        pass

    def summary(self):
        return {}


_NULL_REQUESTS = _NullRequests()


class Telemetry:
    """One handle threading the telemetry pillars through an engine."""

    def __init__(self, *, enabled: bool, trace, registry, requests, clock):
        self.enabled = enabled
        self.trace = trace
        self.registry = registry
        self.requests = requests
        self.clock = clock

    @classmethod
    def make(cls, *, trace_capacity: int = 65536, clock=None) -> "Telemetry":
        clock = clock or time.perf_counter
        registry = MetricsRegistry()
        return cls(enabled=True,
                   trace=TraceRecorder(capacity=trace_capacity, clock=clock),
                   registry=registry,
                   requests=RequestTracker(registry, clock=clock),
                   clock=clock)

    @classmethod
    def disabled(cls) -> "Telemetry":
        return cls(enabled=False, trace=NULL_TRACE, registry=None,
                   requests=_NULL_REQUESTS, clock=time.perf_counter)

    def now_us(self) -> float:
        return self.clock() * 1e6

    # ------------------------------------------------------------ export
    def write_trace(self, path: str) -> None:
        self.trace.write(path)

    def write_metrics(self, path: str, extra: "dict | None" = None) -> dict:
        """Append one snapshot line (latency summaries + extras) to JSONL."""
        if self.registry is None:
            raise RuntimeError("cannot snapshot disabled telemetry")
        merged = {"requests": self.requests.summary()}
        if extra:
            merged.update(extra)
        return self.registry.write_jsonl(path, merged)


def make_telemetry(enabled: bool, *, trace_capacity: int = 65536,
                   clock=None) -> Telemetry:
    """`Telemetry.make` or the shared-nothing disabled handle."""
    return (Telemetry.make(trace_capacity=trace_capacity, clock=clock)
            if enabled else Telemetry.disabled())
