"""Counter/gauge/histogram registry + per-request serving latency metrics
(a copy of `repro.obs.metrics`; pure host-side Python).

`MetricsRegistry` is the aggregate side of the telemetry subsystem (the
trace is the timeline side): named counters, gauges, and bounded-memory
histograms, snapshotted to plain dicts and appended to a JSONL file so a
long serving run leaves a machine-readable latency record next to the
BENCH_*.json perf trajectory.

`RequestTracker` derives the two serving SLO quantities from request
lifecycle callbacks on an injected clock:

  TTFT  time-to-first-token: submit -> first sampled token.  Under chunked
        prefill this is the quantity the scheduler's flat token budget
        trades against throughput (a bigger chunk finishes prompts sooner
        but bursts the per-step traffic).
  TPOT  time-per-output-token: mean inter-token gap after the first token
        (finish - first_token) / (tokens - 1); the decode-side SLO.

Histograms keep exact samples up to `max_samples`, then decimate
deterministically (drop every second retained sample and double the
recording stride), so memory stays bounded on unbounded runs while
percentiles remain representative; `count`/`sum` always cover every
observation.
"""
from __future__ import annotations

import json
import math
import time


def percentile(samples: "list[float]", q: float) -> float:
    """Linear-interpolated percentile (q in [0, 100]) of raw samples.

    Matches numpy's default ("linear") method; implemented here so the
    metrics path has no array dependency and the math is unit-testable.
    """
    if not samples:
        return math.nan
    if not 0.0 <= q <= 100.0:
        raise ValueError("q in [0, 100]")
    xs = sorted(samples)
    if len(xs) == 1:
        return float(xs[0])
    rank = (len(xs) - 1) * (q / 100.0)
    lo = int(rank)
    hi = min(lo + 1, len(xs) - 1)
    frac = rank - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


class Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Bounded-memory histogram with exact-then-decimated samples."""

    def __init__(self, max_samples: int = 4096):
        if max_samples < 2:
            raise ValueError("max_samples >= 2")
        self.max_samples = max_samples
        self._samples: "list[float]" = []
        self._stride = 1          # record every `stride`-th observation
        self._pending = 0         # observations since the last recorded one
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self._pending += 1
        if self._pending < self._stride:
            return
        self._pending = 0
        if len(self._samples) >= self.max_samples:
            # deterministic decimation: thin the history, slow the intake
            self._samples = self._samples[::2]
            self._stride *= 2
        self._samples.append(v)

    @property
    def samples(self) -> "tuple[float, ...]":
        return tuple(self._samples)

    def quantile(self, q: float) -> float:
        return percentile(self._samples, q)

    def summary(self) -> dict:
        return {
            "count": self.count,
            "mean": self.sum / self.count if self.count else math.nan,
            "min": self.min if self.count else math.nan,
            "max": self.max if self.count else math.nan,
            "p50": self.quantile(50.0),
            "p90": self.quantile(90.0),
            "p99": self.quantile(99.0),
            "retained_samples": len(self._samples),
        }


class MetricsRegistry:
    """Named metric store; `snapshot()` is the JSONL export unit."""

    def __init__(self):
        self._counters: "dict[str, Counter]" = {}
        self._gauges: "dict[str, Gauge]" = {}
        self._hists: "dict[str, Histogram]" = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str, max_samples: int = 4096) -> Histogram:
        return self._hists.setdefault(name, Histogram(max_samples))

    def snapshot(self, extra: "dict | None" = None) -> dict:
        snap = {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: g.value for k, g in self._gauges.items()},
            "histograms": {k: h.summary() for k, h in self._hists.items()},
        }
        if extra:
            snap.update(extra)
        return snap

    def write_jsonl(self, path: str, extra: "dict | None" = None) -> dict:
        """Append one snapshot line to `path`; NaNs are serialized as null
        (strict-JSON consumers must stay able to parse the file)."""
        snap = self.snapshot(extra)
        with open(path, "a") as f:
            json.dump(_null_nans(snap), f)
            f.write("\n")
        return snap


def _null_nans(obj):
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: _null_nans(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_null_nans(v) for v in obj]
    return obj


class RequestTracker:
    """Per-request TTFT/TPOT derivation from engine lifecycle callbacks."""

    def __init__(self, registry: "MetricsRegistry | None" = None, clock=None):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.clock = clock or time.perf_counter
        self._submit: "dict[int, float]" = {}
        self._first: "dict[int, float]" = {}

    def on_submit(self, rid: int) -> None:
        self._submit[rid] = self.clock()
        self.registry.counter("requests_submitted").inc()

    def on_first_token(self, rid: int) -> None:
        if rid in self._first:      # resume after preemption re-samples
            return
        now = self.clock()
        self._first[rid] = now
        sub = self._submit.get(rid)
        if sub is not None:
            self.registry.histogram("ttft_s").observe(now - sub)

    def on_finish(self, rid: int, tokens: int) -> None:
        now = self.clock()
        first = self._first.pop(rid, None)
        self._submit.pop(rid, None)
        self.registry.counter("requests_completed").inc()
        self.registry.counter("tokens_emitted").inc(tokens)
        if first is not None and tokens > 1:
            self.registry.histogram("tpot_s").observe(
                (now - first) / (tokens - 1))

    def summary(self) -> dict:
        reg = self.registry
        return {
            "requests_submitted": reg.counter("requests_submitted").value,
            "requests_completed": reg.counter("requests_completed").value,
            "tokens_emitted": reg.counter("tokens_emitted").value,
            "ttft": reg.histogram("ttft_s").summary(),
            "tpot": reg.histogram("tpot_s").summary(),
        }
