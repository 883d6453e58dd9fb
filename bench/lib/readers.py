"""What the per-layer readers under `bench/metrics/` share: a run's
numbers taken apart the same way for each layer."""
from __future__ import annotations

from bench.lib.counts import PEAK_BF16


def device_ms(run, rng: str):
    """Mean device milliseconds of one call of the `bench.<rng>` range in
    the traced slice, or None where it has no call or no device time."""
    calls = (run.trace or {}).get("ranges", {}).get(rng, [])
    if not calls or sum(calls) <= 0:
        return None
    return 1e3 * sum(calls) / len(calls)


def roofline_share(run, op: str):
    """Sum of the bounds of the op's calls in the traced slice
    (`bench.lib.counts`, from each call's shapes) over the device time of
    the kernels launched inside the op's ranges, in %."""
    if not run.trace or not run.bounds:
        return None
    bound, n = run.bounds.get(op, (0.0, 0))
    spent = sum(run.trace.get("ranges", {}).get(op, []))
    if not n or spent <= 0:
        return None
    return 100.0 * bound / spent


def idle_share(run):
    """% of the traced slice in which no operation ran on the device."""
    t = run.trace
    if not t or t.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def mfu(run):
    """Model FLOPs of the window's steps outside the traced slice over
    their seconds x the bf16 tensor-core peak, in %."""
    a, b = run.traced_steps
    ends = run.step_ends
    if not run.step_flops or len(ends) != len(run.step_flops):
        return None
    flops = secs = 0.0
    prev = run.t0
    for i, (t, f) in enumerate(zip(ends, run.step_flops)):
        if not a <= i < b:
            flops += f
            secs += t - prev
        prev = t
    if secs <= 0:
        return None
    return 100.0 * flops / (secs * PEAK_BF16)
