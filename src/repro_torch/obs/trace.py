"""Span/event recorder exporting Chrome/Perfetto trace-event JSON (a copy of
`repro.obs.trace`).

The paper's argument is a bandwidth-utilization *timeline* — rewrite and
compute activity laid out against wall time so the flat-traffic property is
visible, not just summarized.  This module is that timeline for the repo:
a `TraceRecorder` collects events into a bounded ring buffer and exports
them in the Chrome trace-event format (``{"traceEvents": [...]}``), which
Perfetto (https://ui.perfetto.dev) and ``chrome://tracing`` both load
directly.

Design constraints, in order:

  * near-zero overhead when disabled — `NULL_TRACE` is a method-compatible
    singleton whose every call is a constant-time no-op, so instrumentation
    sites cost one attribute check;
  * bounded memory — a ring buffer of `capacity` events; once full the
    OLDEST event is dropped and `dropped` counts it (a long serving run
    keeps the most recent window, and the drop count says how much history
    fell off the back);
  * explicit clock injection — every timestamp flows through the `clock`
    callable (seconds, `time.perf_counter` by default), so tests drive a
    fake clock and get deterministic traces.

Event vocabulary (Chrome trace-event phases used):

  ``X``   complete event: a span with `ts` + `dur` (`complete`, `span`)
  ``i``   instant event (`instant`)
  ``C``   counter track (`counter`)
  ``b``/``e``  async span keyed by `id` — request lifecycles that overlap
          arbitrarily across lanes (`async_begin` / `async_end`)
  ``M``   metadata: process/thread names for the Perfetto track labels

All timestamps in the export are microseconds (the trace-event unit).
"""
from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager


class TraceRecorder:
    """Bounded ring-buffer trace-event recorder (see module docstring)."""

    enabled = True

    def __init__(self, capacity: int = 65536, clock=None):
        if capacity < 1:
            raise ValueError("capacity >= 1")
        self.capacity = capacity
        self.clock = clock or time.perf_counter
        self._events: "deque[dict]" = deque()
        self._meta: "list[dict]" = []     # M events: never dropped, tiny
        self.dropped = 0

    # ------------------------------------------------------------- core
    def now_us(self) -> float:
        """Current clock reading in trace-event microseconds."""
        return self.clock() * 1e6

    def emit(self, event: dict) -> None:
        """Append one raw trace-event dict, honoring the ring capacity."""
        if len(self._events) >= self.capacity:
            self._events.popleft()
            self.dropped += 1
        self._events.append(event)

    def __len__(self) -> int:
        return len(self._events)

    @property
    def events(self) -> "tuple[dict, ...]":
        return tuple(self._events)

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0

    # ---------------------------------------------------------- emitters
    def complete(self, name: str, ts_us: float, dur_us: float, *,
                 pid: int = 0, tid: int = 0, args: "dict | None" = None,
                 cat: str = "span") -> None:
        ev = {"name": name, "ph": "X", "ts": ts_us, "dur": max(0.0, dur_us),
              "pid": pid, "tid": tid, "cat": cat}
        if args:
            ev["args"] = args
        self.emit(ev)

    def instant(self, name: str, *, ts_us: "float | None" = None,
                pid: int = 0, tid: int = 0, args: "dict | None" = None,
                cat: str = "event") -> None:
        ev = {"name": name, "ph": "i", "s": "t",
              "ts": self.now_us() if ts_us is None else ts_us,
              "pid": pid, "tid": tid, "cat": cat}
        if args:
            ev["args"] = args
        self.emit(ev)

    def counter(self, name: str, values: dict, *,
                ts_us: "float | None" = None, pid: int = 0) -> None:
        self.emit({"name": name, "ph": "C",
                   "ts": self.now_us() if ts_us is None else ts_us,
                   "pid": pid, "tid": 0, "args": dict(values)})

    def async_begin(self, name: str, aid: int, *,
                    ts_us: "float | None" = None, pid: int = 0,
                    args: "dict | None" = None, cat: str = "request") -> None:
        ev = {"name": name, "ph": "b", "id": aid, "cat": cat,
              "ts": self.now_us() if ts_us is None else ts_us,
              "pid": pid, "tid": 0}
        if args:
            ev["args"] = args
        self.emit(ev)

    def async_end(self, name: str, aid: int, *,
                  ts_us: "float | None" = None, pid: int = 0,
                  args: "dict | None" = None, cat: str = "request") -> None:
        ev = {"name": name, "ph": "e", "id": aid, "cat": cat,
              "ts": self.now_us() if ts_us is None else ts_us,
              "pid": pid, "tid": 0}
        if args:
            ev["args"] = args
        self.emit(ev)

    @contextmanager
    def span(self, name: str, *, pid: int = 0, tid: int = 0,
             args: "dict | None" = None, cat: str = "span"):
        """Measure a with-block on the injected clock, emit one X event."""
        t0 = self.now_us()
        try:
            yield self
        finally:
            self.complete(name, t0, self.now_us() - t0,
                          pid=pid, tid=tid, args=args, cat=cat)

    # ---------------------------------------------------------- metadata
    def name_process(self, pid: int, name: str) -> None:
        self._meta.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": name}})

    def name_thread(self, pid: int, tid: int, name: str) -> None:
        self._meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": name}})

    # ------------------------------------------------------------ export
    def to_chrome(self) -> dict:
        """Chrome/Perfetto trace-event JSON object (load it directly)."""
        return {
            "traceEvents": self._meta + list(self._events),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped,
                          "capacity": self.capacity},
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
            f.write("\n")


class _NullTrace:
    """Disabled-path stand-in: every method is a no-op; instrumentation
    sites gate heavier work (clock reads, arg dict construction) on
    `trace.enabled` and fall through to these for anything else."""

    enabled = False
    dropped = 0
    capacity = 0
    events: "tuple[dict, ...]" = ()

    def now_us(self) -> float:
        return 0.0

    def __len__(self) -> int:
        return 0

    def emit(self, event) -> None:
        pass

    def complete(self, *a, **k) -> None:
        pass

    def instant(self, *a, **k) -> None:
        pass

    def counter(self, *a, **k) -> None:
        pass

    def async_begin(self, *a, **k) -> None:
        pass

    def async_end(self, *a, **k) -> None:
        pass

    @contextmanager
    def span(self, *a, **k):
        yield self

    def name_process(self, *a, **k) -> None:
        pass

    def name_thread(self, *a, **k) -> None:
        pass

    def clear(self) -> None:
        pass

    def to_chrome(self) -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def write(self, path: str) -> None:
        raise RuntimeError("cannot write a disabled trace (NULL_TRACE)")


NULL_TRACE = _NullTrace()

# Fixed pid layout for the serving instrumentation so every exported trace
# lands request/engine/kernel activity on the same named tracks.
PID_SERVING = 1    # engine steps (tid 0) + one tid per lane (TID_LANE0 + i)
PID_REQUESTS = 2   # async request-lifecycle spans keyed by rid
PID_KERNEL = 3     # chunk-issue schedule lanes: tid 0 = DMA, tid 1 = compute
TID_ENGINE = 0
TID_LANE0 = 10
TID_DMA = 0
TID_COMPUTE = 1


def annotate_serving_tracks(trace: "TraceRecorder", slots: int) -> None:
    """Name the fixed serving/kernel tracks on a fresh recorder."""
    if not trace.enabled:
        return
    trace.name_process(PID_SERVING, "serving engine")
    trace.name_thread(PID_SERVING, TID_ENGINE, "steps")
    for lane in range(slots):
        trace.name_thread(PID_SERVING, TID_LANE0 + lane, f"lane {lane}")
    trace.name_process(PID_REQUESTS, "requests")
    trace.name_process(PID_KERNEL, "kernel chunk schedule")
    trace.name_thread(PID_KERNEL, TID_DMA, "DMA lane (HBM->VMEM)")
    trace.name_thread(PID_KERNEL, TID_COMPUTE, "compute lane")
