"""Serving CLI: batched requests through the paged-KV engine, or the
dense-cache engine for the recurrent archs, on the card.

  python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --requests 6 --max-new 16
  python -m repro_torch.launch.serve --arch zamba2-2.7b     # dense engine
  python -m repro_torch.launch.serve --arch qwen1.5-0.5b --engine dense

runs on CUDA; `--device cpu` runs the plain PyTorch path on the CPU (tests,
smoke runs).  Without CUDA and without `--device cpu` it raises.  Flags are
the reference CLI's (`repro.launch.serve`), plus `--device`.  `--engine
auto` takes the paged engine where the arch allows it, else the dense one;
embedding-input archs (musicgen, llama-3.2-vision) are refused, as the
reference refuses them.

  --prefix-cache [--prefix-cache-blocks N]   shared-prefix KV reuse
  --speculation --draft-source model --draft-model ARCH   draft-model drafts
  --obs / --trace-out PATH / --metrics-out PATH   telemetry
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--engine", choices=("auto", "paged", "dense"),
                    default="auto",
                    help="paged, dense (the dense-cache engine: whole-"
                         "prompt prefill, one decode call a lane position) "
                         "or auto (paged where the arch allows it)")
    ap.add_argument("--block-size", type=int, default=0,
                    help="paged-KV block size (0 = cfg.serve_block_size)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill chunk tokens (0 = plan_serve_chunk)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged-attn", choices=("auto", "kernel", "ref"),
                    default="auto",
                    help="paged-attention read path: kernel streams KV "
                         "blocks through the CUDA ring kernel, ref gathers "
                         "pools (auto: kernel on CUDA, ref on CPU)")
    ap.add_argument("--prefix-cache", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="radix-tree shared-prefix KV reuse: admission maps "
                         "previously computed prompt-prefix blocks into the "
                         "lane's tables and prefill skips them (default: "
                         "cfg.prefix_cache)")
    ap.add_argument("--prefix-cache-blocks", type=int, default=None,
                    help="cap on blocks the prefix index may hold "
                         "(0 = unbounded; default: cfg.prefix_cache_blocks)")
    ap.add_argument("--speculation", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="speculative decoding: drafts scored in one "
                         "batched verify pass of draft_len+1 tokens per "
                         "lane; the greedy stream is the same as with "
                         "speculation off (default: cfg.speculation)")
    ap.add_argument("--draft-len", type=int, default=0,
                    help="max draft tokens per lane per verify step "
                         "(0 = cfg.draft_len)")
    ap.add_argument("--draft-source", choices=("self", "model"),
                    default="self",
                    help="'self' mines n-grams of the lane's history and "
                         "the prefix index; 'model' rolls out --draft-model "
                         "greedily")
    ap.add_argument("--draft-model", default=None,
                    help="registry arch of the draft model for "
                         "--draft-source model (its SMOKE config with "
                         "--smoke; random weights from --seed + 1)")
    ap.add_argument("--obs", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="serving telemetry: request / kernel trace spans, "
                         "TTFT / TPOT histograms, step wall times (default: "
                         "cfg.obs; implied by --trace-out / --metrics-out)")
    ap.add_argument("--trace-out", default=None,
                    help="write the Chrome / Perfetto trace-event JSON here")
    ap.add_argument("--metrics-out", default=None,
                    help="append one JSONL metrics snapshot here (TTFT / "
                         "TPOT summaries, ledger totals, predicted vs "
                         "measured utilization)")
    ap.add_argument("--trace-capacity", type=int, default=0,
                    help="trace ring-buffer capacity in events "
                         "(0 = cfg.obs_trace_capacity)")
    ap.add_argument("--metrics-retention", type=int, default=None,
                    help="ledger rows kept in memory (None = "
                         "cfg.metrics_retention, 0 = unbounded)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu only when asked for")
    args = ap.parse_args(argv)
    obs = args.obs
    if obs is None and (args.trace_out or args.metrics_out):
        obs = True

    import numpy as np
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    from repro_torch.serving.dense_engine import DenseServingEngine
    from repro_torch.serving.engine import (ServeConfig, ServingEngine,
                                            make_engine)

    cfg = registry.get_config(args.arch, smoke=args.smoke)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch} takes embedding inputs; serve the "
                         "token archs (stub frontends have no tokenizer)")
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tf.init_params(cfg, gen, device)
    serve = ServeConfig(
        slots=args.slots, max_len=args.max_len, temperature=args.temperature,
        seed=args.seed, block_size=args.block_size,
        prefill_chunk=args.prefill_chunk, paged_attn_kernel=args.paged_attn,
        prefix_cache=args.prefix_cache,
        prefix_cache_blocks=args.prefix_cache_blocks,
        speculation=args.speculation, draft_len=args.draft_len,
        draft_source=args.draft_source, obs=obs,
        trace_capacity=args.trace_capacity,
        metrics_retention=args.metrics_retention, device=str(device))
    draft_model = None
    if args.draft_model:
        dcfg = registry.get_config(args.draft_model, smoke=args.smoke)
        dgen = torch.Generator(device=device).manual_seed(args.seed + 1)
        draft_model = (dcfg, tf.init_params(dcfg, dgen, device))
    if args.engine == "paged":
        engine = ServingEngine(cfg, params, serve, draft_model=draft_model)
    elif args.engine == "dense":
        engine = DenseServingEngine(cfg, params, serve)
    else:
        engine = make_engine(cfg, params, serve, draft_model=draft_model)
    kind = type(engine).__name__

    rng = np.random.default_rng(0)
    rids = []
    t0 = time.perf_counter()
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=rng.integers(4, 12)).tolist()
        rids.append(engine.submit(prompt, max_new_tokens=args.max_new))
    results = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(v) for v in results.values())
    for rid in rids:
        print(f"request {rid}: {len(results[rid])} tokens -> "
              f"{results[rid][:8]}...")
    print(f"{len(rids)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s aggregate, {kind}, {device})")
    peak_blocks = max(m["blocks_in_use"] for m in engine.metrics)
    print(f"steps={len(engine.metrics)} tokens/step_cov="
          f"{engine.flatness_cov():.3f} peak_blocks={peak_blocks} "
          f"shapes={engine.trace_counts}")
    if getattr(engine, "prefix", None) is not None:
        print(f"prefix_cache: hit_rate={engine.prefix_hit_rate():.2f} "
              f"hit_tokens={engine.metrics.total('prefix_hit_tokens')} "
              f"saved_bytes={engine.metrics.total('prefix_saved_bytes')} "
              f"blocks_held={engine.prefix.blocks_held}")
    if getattr(engine, "draft_len", 0):
        print(f"speculation: drafted={engine.metrics.total('drafted_tokens')} "
              f"accepted={engine.metrics.total('accepted_tokens')} "
              f"acceptance_rate={engine.acceptance_rate():.2f} "
              f"draft_len={engine.draft_len} source={engine.draft_source}")
    if engine.obs.enabled:
        req = engine.obs.requests.summary()
        ttft, tpot = req["ttft"], req["tpot"]
        print(f"ttft_s: p50={ttft['p50']:.4f} p99={ttft['p99']:.4f} "
              f"(n={ttft['count']})  tpot_s: p50={tpot['p50']:.4f} "
              f"p99={tpot['p99']:.4f} (n={tpot['count']})")
        util = engine.metrics.utilization_report()
        print(f"bw_utilization: measured="
              f"{util['measured_bw_utilization']:.3f} predicted="
              f"{util['predicted_bw_utilization']:.3f} "
              f"cov={util['hbm_bytes_per_step_cov']:.3f}")
        if args.trace_out:
            engine.obs.write_trace(args.trace_out)
            print(f"trace: {args.trace_out} "
                  f"({len(engine.obs.trace)} events, "
                  f"{engine.obs.trace.dropped} dropped)")
        if args.metrics_out:
            engine.obs.write_metrics(
                args.metrics_out, extra={"ledger": engine.metrics.summary()})
            print(f"metrics: {args.metrics_out}")
    return results


if __name__ == "__main__":
    main()
