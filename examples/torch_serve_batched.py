"""Serve a small model on the PyTorch port with batched requests through the
paged-KV continuous-batching engine (chunked prefill + block-table decode),
then a multi-turn round with the radix-tree prefix cache: every
conversation opens with the same system prompt and each follow-up turn
replays its full history, so the engine maps the matched KV blocks straight
into the lane's tables and prefills only the novel suffix.  Then a
speculative-decoding round: self-drafted prompt-lookup n-grams ride one
batched verify step per schedule tick, emitting up to draft_len+1 tokens
per lane per weight stream, with the output stream token-identical to
plain decode.  Last, a round with telemetry on, whose trace and metrics
snapshot land in the working directory.

    PYTHONPATH=src python examples/torch_serve_batched.py                # card
    PYTHONPATH=src python examples/torch_serve_batched.py --device cpu

On the card the engine runs the port's kernels: the tensor-core
`gpp_matmul` for the bf16 projections, its FMA route for the f32 logits
head, RMSNorm, and paged attention with its merge.
"""
import argparse
import os
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import ServeConfig, ServingEngine


def run(device: str = "cuda", out_dir: str = ".") -> dict:
    """The four rounds; prints what the JAX example prints and returns its
    figures.  The trace and the metrics snapshot go to `out_dir`."""
    dev = resolve_device(device)
    cfg = registry.get_config("qwen1.5-0.5b", smoke=True)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev)
    serve = dict(max_len=96, device=str(dev))
    engine = ServingEngine(cfg, params, ServeConfig(slots=4, **serve))

    rng = np.random.default_rng(0)
    rids = [engine.submit(rng.integers(0, cfg.vocab_size,
                                       size=rng.integers(4, 16)).tolist(),
                          max_new_tokens=12)
            for _ in range(8)]

    t0 = time.perf_counter()
    results = engine.run()
    dt = time.perf_counter() - t0
    tokens = sum(len(v) for v in results.values())
    for rid in rids:
        assert len(results[rid]) >= 1
        print(f"req {rid}: {results[rid]}")
    print(f"{tokens} tokens across {len(rids)} requests in {dt:.2f}s "
          f"({tokens/dt:.1f} tok/s, continuous batching over 4 slots)")
    print(f"tokens/step cov={engine.flatness_cov():.3f} "
          f"(chunk={engine.chunk}, block={engine.block_size}, "
          f"compiled shapes={engine.trace_counts})")
    out = {"results": [results[r] for r in rids], "tokens": tokens,
           "seconds": dt, "tok_s": tokens / dt,
           "trace_counts": {"batched": dict(engine.trace_counts)}}

    # ---- multi-turn with shared-prefix KV reuse --------------------------
    eng = ServingEngine(cfg, params, ServeConfig(
        slots=2, prefix_cache=True, **serve))
    system = list(range(100, 132))        # 32-token shared system prompt
    history = {}
    for user in range(3):                 # turn 1: same system prompt
        prompt = system + rng.integers(0, cfg.vocab_size, size=5).tolist()
        rid = eng.submit(prompt, max_new_tokens=8)
        eng.run()
        history[user] = prompt + eng.result(rid)
    for user in range(3):                 # turn 2: full history replayed
        prompt = history[user] + rng.integers(0, cfg.vocab_size,
                                              size=4).tolist()
        rid = eng.submit(prompt, max_new_tokens=8)
        eng.run()
        assert len(eng.result(rid)) == 8
    hit_tokens = sum(m["prefix_hit_tokens"] for m in eng.metrics)
    shared_peak = max(m["blocks_shared"] for m in eng.metrics)
    print(f"prefix cache: hit_rate={eng.prefix_hit_rate():.2f} "
          f"hit_tokens={hit_tokens} peak_shared_blocks={shared_peak} "
          f"(turn-2 prefills skipped their replayed history)")
    assert eng.prefix_hit_rate() > 0 and hit_tokens >= len(system)
    out["prefix"] = {"hit_rate": eng.prefix_hit_rate(),
                     "hit_tokens": hit_tokens, "peak_shared": shared_peak}
    out["trace_counts"]["prefix"] = dict(eng.trace_counts)

    # ---- speculative decoding (self-drafted, batched verify) -------------
    reps = [np.tile([5, 6, 7, 8], 6).tolist(), np.tile([9, 3], 10).tolist()]

    def decode(spec):
        eng = ServingEngine(cfg, params, ServeConfig(
            slots=2, speculation=spec, draft_len=4 if spec else 0, **serve))
        rids = [eng.submit(p, max_new_tokens=16) for p in reps]
        res = eng.run()
        return [res[r] for r in rids], eng

    plain, plain_eng = decode(False)
    spec, eng = decode(True)
    assert spec == plain                  # speculation never changes output
    print(f"speculation: acceptance_rate={eng.acceptance_rate():.2f} "
          f"steps={len(eng.metrics)} vs {len(plain_eng.metrics)} plain "
          f"(same token streams), compiled shapes={eng.trace_counts}")
    out["spec"] = {"acceptance_rate": eng.acceptance_rate(),
                   "steps": len(eng.metrics),
                   "plain_steps": len(plain_eng.metrics), "streams": spec}
    out["trace_counts"]["spec"] = dict(eng.trace_counts)

    # ---- observability: demo trace + metrics snapshot --------------------
    # obs=True turns on the telemetry layer: async request spans, per-step /
    # phase spans, modelled kernel copy / compute lanes, and TTFT / TPOT
    # histograms; the token stream is unchanged.
    eng = ServingEngine(cfg, params, ServeConfig(slots=2, obs=True,
                                                 **serve))
    for _ in range(4):
        eng.submit(rng.integers(0, cfg.vocab_size,
                                size=rng.integers(4, 16)).tolist(),
                   max_new_tokens=8)
    eng.run()
    trace_path = os.path.join(out_dir, "serve_trace.json")
    eng.obs.write_trace(trace_path)
    snap = eng.obs.write_metrics(os.path.join(out_dir, "serve_metrics.jsonl"),
                                 extra={"ledger": eng.metrics.summary()})
    ttft = snap["requests"]["ttft"]
    util = eng.metrics.utilization_report()
    print(f"observability: {len(eng.obs.trace)} trace events -> "
          f"serve_trace.json (load at https://ui.perfetto.dev), "
          f"ttft_p50={ttft['p50'] * 1e3:.1f}ms, bw_utilization "
          f"measured={util['measured_bw_utilization']:.2f} vs "
          f"predicted={util['predicted_bw_utilization']:.2f}")
    out["obs"] = {"trace_events": len(eng.obs.trace),
                  "ttft_p50_s": ttft["p50"],
                  "measured_bw_utilization": util["measured_bw_utilization"],
                  "predicted_bw_utilization":
                      util["predicted_bw_utilization"]}
    out["trace_counts"]["obs"] = dict(eng.trace_counts)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu only when asked for")
    args = ap.parse_args(argv)
    return run(args.device)


if __name__ == "__main__":
    main()
