"""A training cell: the program's train step (`repro_torch.launch.steps.
make_train_step`, as `launch.train` builds it) on batches drawn from the
seed, timed for `seconds`.

Set-up builds one object, the step with the model and its AdamW state,
and drives it through the job's first three steps: the same call and
feed the window uses, on rows that all differ.  From them it keeps what
the check compares: each step's loss, the first gradient as the optimizer
got it (each leaf's norm, from its first moment after one step: m / (1 -
b1)), and each leaf's change after the three (taken before step 4 writes
the leaves again; the starting leaves are drawn again from the seed).
The window then runs steps 4, 5, ... on the same object.  After it the
program's state is freed and the plain reference trains the same three
steps in f32.
"""
from __future__ import annotations

import dataclasses
import gc
import time

import torch

from bench.lib import check_train, counts
from bench.lib.model_cfg import program_config, published
from bench.lib.serve import _window_over
from bench.lib.weights import leaves, make_params


@dataclasses.dataclass
class TrainRun:
    """What a run saw, for the end-to-end metrics and the layer readers."""
    tokens_per_step: int = 0
    t0: float = 0.0
    t_end: float = 0.0
    step_ends: list = dataclasses.field(default_factory=list)
    step_flops: list = dataclasses.field(default_factory=list)
    traced_steps: "tuple[int, int]" = (0, 0)
    trace: "dict | None" = None
    bounds: "dict | None" = None
    attempted: int = 0
    failed: int = 0

    def tokens_per_s(self) -> float:
        return len(self.step_ends) * self.tokens_per_step \
            / (self.t_end - self.t0)


def batch(seed: int, k: int, B: int, T: int, vocab: int, device):
    """Step k's batch: token ids of (B, T + 1) drawn from (seed, k); the
    labels are the tokens shifted by one."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + k) % (1 << 63))
    ids = torch.randint(0, vocab, (B, T + 1), generator=g, device=device,
                        dtype=torch.int64).to(torch.int32)
    return {"tokens": ids[:, :-1].contiguous(),
            "labels": ids[:, 1:].contiguous()}


def run_train(conf: dict, cell: dict, mix: dict, seed: int, seconds: float,
              trace: bool, device: str = "cuda", smoke: bool = False,
              t_process: "float | None" = None, fault=None) -> dict:
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from bench.lib.trace import Ranges, reduce_events

    t_start = time.perf_counter() if t_process is None else t_process
    mcfg = program_config(conf, smoke=smoke)
    if cell.get("dtype"):            # tests: the small model in f32
        mcfg = mcfg.with_(dtype=cell["dtype"])
    pub = published(conf, mcfg, smoke=smoke)
    dev = torch.device(device)
    job = cell["job"]
    B, T = int(mix["batch"]), int(mix["seq_len"])
    opt = job["adamw"]
    first = int(job["first_step"])
    checked = int(cell["check"]["steps"])
    ranges = None
    if trace:
        ranges = Ranges()
        ranges.install()
    try:
        specs = tf.param_specs(mcfg)
        scale = cell.get("init_scale", 0.02)
        params = make_params(specs, seed, dev, scale=scale)
        state = adamw.adamw_init(params)
        optc = adamw.AdamWConfig(
            lr=opt["lr"], b1=opt["b1"], b2=opt["b2"], eps=opt["eps"],
            weight_decay=opt["weight_decay"], clip_norm=opt["clip_norm"])
        step_fn = make_train_step(mcfg, optc=optc).fn
        if fault is not None:
            step_fn = fault(step_fn)
        run = TrainRun(tokens_per_step=B * T)
        losses, first_g = [], None
        for k in range(checked):
            run.attempted += 1
            params, state, m = step_fn(params, state,
                                       batch(seed, k, B, T,
                                             mcfg.vocab_size, dev),
                                       first + k)
            losses.append(float(m["loss"]))
            if k == 0:
                first_g = {p: float(torch.linalg.vector_norm(x))
                           / (1 - opt["b1"])
                           for p, x in leaves(state["mu"])}
        p0 = dict(leaves(make_params(specs, seed, dev, scale=scale)))
        change = {p: float(torch.linalg.vector_norm(x.float()
                                                    - p0[p].float()))
                  for p, x in leaves(params)}
        del p0
        if dev.type == "cuda":
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start

        # ------------------------------------------------------- window
        flops = counts.train_flops(pub, B, T)
        slice_at = int(cell.get("trace_from_step", 1))
        slice_n = int(cell.get("trace_steps", 2))
        prof = None
        prof_t = [0.0, 0.0]
        k = checked
        n = 0
        run.t0 = time.perf_counter()
        while True:
            if trace and n == slice_at:
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                ranges.recording = True
                prof_t[0] = time.perf_counter()
            run.attempted += 1
            params, state, m = step_fn(params, state,
                                       batch(seed, k, B, T,
                                             mcfg.vocab_size, dev),
                                       first + k)
            if not torch.isfinite(m["loss"]):
                run.failed += 1
            run.step_ends.append(time.perf_counter())
            run.step_flops.append(flops)
            k += 1
            n += 1
            if prof is not None and n == slice_at + slice_n:
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                prof_t[1] = time.perf_counter()
                run.step_ends[-1] = prof_t[1]
                ranges.recording = False
                prof.__exit__(None, None, None)
                run.traced_steps = (slice_at, slice_at + slice_n)
            if _window_over(cell, n, time.perf_counter() - run.t0,
                            seconds) and (not trace
                                          or n >= slice_at + slice_n):
                break
        run.t_end = run.step_ends[-1]
        if trace:
            red = reduce_events(prof)
            red["window_s"] = prof_t[1] - prof_t[0]
            run.trace = red
            run.bounds = ranges.bounds()
        memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)
        del params, state, m
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        verdict = check_train.judge(cell, pub, seed, dev, specs, scale,
                                    (B, T, mcfg.vocab_size),
                                    (losses, first_g, change))
    finally:
        if ranges is not None:
            ranges.uninstall()
    return {"setup_s": setup_s, "memory_peak": memory_peak,
            "verdict": verdict, "run": run}
