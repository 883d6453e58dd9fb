"""A serving cell: the program's paged engine under a closed loop of
clients, driven one `step()` at a time so every output token gets the time
of the step that returned it.

Set-up makes the weights from the seed on the device, builds the engine
(`repro_torch.serving.engine.make_engine`, as `launch.serve` does), submits
one request a client and steps until every client's first request has its
first token: every lane has then run a prefill chunk and a decode step, the
shapes the window uses.  Each first request asks for the tokens it makes
during that fill plus a residual length (`traffic.ClosedLoop`), so none
completes before the window and the window opens with every lane decoding,
the closed loop's steady state, not a queue left by the fill.  The window
then steps for `seconds`; a client that completes a request submits its
next one at once.  After the window the program's KV pools are freed and
the plain reference judges a sample of the requests the window finished.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np
import torch

from bench.lib import check, counts, traffic
from bench.lib.model_cfg import program_config, published
from bench.lib.weights import make_params


@dataclasses.dataclass
class Tracked:
    index: int              # the request's place in the traffic stream
    rid: int                # the engine's id
    req: object             # the engine's request record (read only)
    prompt: np.ndarray
    submit_t: float
    times: list = dataclasses.field(default_factory=list)
    done_t: "float | None" = None

    @property
    def tokens(self) -> "list[int]":
        return list(self.req.produced)


@dataclasses.dataclass
class ServeRun:
    """What a run saw, for the end-to-end metrics and the layer readers."""
    t0: float = 0.0
    t_end: float = 0.0
    step_ends: list = dataclasses.field(default_factory=list)
    step_work: list = dataclasses.field(default_factory=list)
    step_flops: list = dataclasses.field(default_factory=list)
    requests: list = dataclasses.field(default_factory=list)
    ledger: list = dataclasses.field(default_factory=list)
    host_us: dict = dataclasses.field(default_factory=dict)
    num_blocks: int = 0
    traced_steps: "tuple[int, int]" = (0, 0)
    trace: "dict | None" = None
    bounds: "dict | None" = None
    attempted: int = 0
    failed: int = 0

    @property
    def window_s(self) -> float:
        return self.t_end - self.t0

    def tokens_in_window(self) -> int:
        return sum(self.t0 < t <= self.t_end
                   for r in self.requests for t in r.times)

    def ttft_ms(self) -> "list[float]":
        return [(r.times[0] - r.submit_t) * 1e3 for r in self.requests
                if r.times and self.t0 < r.times[0] <= self.t_end]

    def itl_ms(self) -> "list[float]":
        out = []
        for r in self.requests:
            t = r.times
            out += [(b - a) * 1e3 for a, b in zip(t, t[1:])
                    if a > self.t0 and b <= self.t_end]
        return out


def p95(values) -> "float | None":
    return float(np.percentile(values, 95)) if len(values) else None


class Clients:
    """The closed loop around one engine."""

    def __init__(self, engine, stream: traffic.ClosedLoop, run: ServeRun):
        self.engine = engine
        self.stream = stream
        self.run = run
        self.live: "list[Tracked]" = []

    def submit_next(self) -> None:
        while True:
            r = self.stream.next()
            self.run.attempted += 1
            try:
                rid = self.engine.submit(r.prompt, max_new_tokens=r.max_new)
            except ValueError:
                self.run.failed += 1
                continue
            req = self.engine.scheduler.waiting[-1]
            if req.rid != rid:
                raise RuntimeError("the engine queued another request")
            t = Tracked(r.index, rid, req, r.prompt, time.perf_counter())
            self.live.append(t)
            self.run.requests.append(t)
            return

    def step(self) -> "list[tuple[int, int]]":
        """One engine step; stamps the tokens it returned, resubmits for
        every client that completed, and returns the (position, 1) spans of
        the decoded tokens (their attended positions count as work)."""
        if not self.engine.step():
            raise RuntimeError("the engine has nothing to run")
        t = time.perf_counter()
        spans = []
        still = []
        done = 0
        for r in self.live:
            n = len(r.req.produced)
            for i in range(len(r.times), n):
                r.times.append(t)
                if i >= 1:
                    spans.append((len(r.prompt) + i - 1, 1))
            if self.engine.result(r.rid) is not None:
                r.done_t = t
                done += 1
            else:
                still.append(r)
        self.live = still
        for _ in range(done):
            self.submit_next()
        self.run.step_ends.append(t)
        return spans


def _window_over(cell: dict, steps: int, elapsed: float,
                 seconds: float) -> bool:
    """The window ends after `seconds`, or (tests on the CPU, where time
    says little) after the cell's `window_steps`."""
    if cell.get("window_steps"):
        return steps >= int(cell["window_steps"])
    return elapsed >= seconds


def run_serve(conf: dict, cell: dict, mix: dict, seed: int, seconds: float,
              trace: bool, device: str = "cuda", smoke: bool = False,
              t_process: "float | None" = None, fault=None) -> dict:
    """One run of a serving cell.  Returns the result's fields (without
    the device section) and the run record."""
    from repro_torch.serving.engine import ServeConfig, make_engine
    from repro_torch.models import transformer as tf
    from bench.lib.trace import Ranges, reduce_events

    t_start = time.perf_counter() if t_process is None else t_process
    mcfg = program_config(conf, smoke=smoke)
    if cell.get("dtype"):            # tests: the small model in f32
        mcfg = mcfg.with_(dtype=cell["dtype"])
    pub = published(conf, mcfg, smoke=smoke)
    eng = cell["engine"]
    dev = torch.device(device)
    ranges = None
    if trace:
        ranges = Ranges()
        ranges.install()
    try:
        params = make_params(tf.param_specs(mcfg), seed, dev,
                             scale=cell.get("init_scale", 0.02))
        serve = ServeConfig(
            slots=int(mix["clients"]), max_len=int(eng["max_len"]),
            block_size=int(eng["block_size"]),
            num_blocks=int(eng.get("num_blocks", 0)),
            token_budget=int(eng["token_budget"]), prefix_cache=False,
            speculation=False, obs=bool(trace), metrics_retention=0,
            device=device)
        engine = make_engine(mcfg, params, serve)
        if fault is not None:
            fault(engine)
        run = ServeRun(num_blocks=engine.kv.cfg.num_blocks)
        stream = traffic.ClosedLoop(mix, seed, mcfg.vocab_size,
                                    chunk=engine.chunk)
        drv = Clients(engine, stream, run)
        for _ in range(stream.clients):
            drv.submit_next()
        first = list(drv.live)
        while any(not r.times for r in first):
            drv.step()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start

        # ------------------------------------------------------- window
        rows0 = len(engine.metrics)
        host0 = dict(engine.host_us)
        slice_at = int(cell.get("trace_from_step", 3))
        slice_n = int(cell.get("trace_steps", 6))
        prof = None
        prof_t = [0.0, 0.0]
        run.t0 = time.perf_counter()
        run.step_ends = []
        k = 0
        while True:
            if trace and k == slice_at:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                ranges.recording = True
                prof_t[0] = time.perf_counter()
            n0 = len(ranges.prefill_starts) if trace else 0
            spans = drv.step()
            if trace:
                run.step_work.append((spans, ranges.prefill_starts[n0:]))
            k += 1
            if prof is not None and k == slice_at + slice_n:
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                prof_t[1] = time.perf_counter()
                ranges.recording = False
                prof.__exit__(None, None, None)
                run.traced_steps = (slice_at, slice_at + slice_n)
            if _window_over(cell, k, time.perf_counter() - run.t0,
                            seconds) and (not trace
                                          or k >= slice_at + slice_n):
                break
        run.t_end = run.step_ends[-1]
        run.ledger = [dict(r) for r in engine.metrics[rows0:]]
        run.host_us = {p: engine.host_us[p] - host0[p] for p in host0}
        if trace:
            red = reduce_events(prof)
            red["window_s"] = prof_t[1] - prof_t[0]
            run.trace = red
            a, b = run.traced_steps
            run.bounds = ranges.bounds([r["prefill_real_tokens"]
                                        for r in run.ledger[a:b]
                                        if r["prefill_tokens"]])
            run.step_flops = _step_flops(run, pub)
        memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)
        # ------------------------------------------ free, then the check
        engine.caches = None
        engine.params = None
        del engine, drv
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        verdict = check.judge_serve(cell, pub, params, run, seed, dev)
    finally:
        if ranges is not None:
            ranges.uninstall()
    return {"setup_s": setup_s, "memory_peak": memory_peak,
            "verdict": verdict, "run": run}


def _step_flops(run: ServeRun, pub: dict) -> "list[float]":
    """Model FLOPs of each window step: its decoded tokens (from the
    stamps) and its prefill chunk's real tokens (the ledger's count, from
    the chunk's start position)."""
    out = []
    for (spans, starts), row in zip(run.step_work, run.ledger):
        work = list(spans)
        real = int(row.get("prefill_real_tokens", 0))
        if real and starts:
            work.append((int(starts[0]), real))
        out.append(counts.serve_flops_spans(pub, work))
    return out
