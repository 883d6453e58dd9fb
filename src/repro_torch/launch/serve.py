"""Serving CLI: batched requests through the paged-KV engine on the card.

  python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
      --requests 6 --max-new 16

runs on CUDA; `--device cpu` runs the plain PyTorch path on the CPU (tests,
smoke runs).  Without CUDA and without `--device cpu` it raises.  Flags are
the reference CLI's (`repro.launch.serve`) that this port supports, plus
`--device`.
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
    ap.add_argument("--speculation", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="speculative decoding: n-gram self-drafts scored "
                         "in one batched verify pass of draft_len+1 tokens "
                         "per lane; the greedy stream is the same as with "
                         "speculation off (default: cfg.speculation)")
    ap.add_argument("--draft-len", type=int, default=0,
                    help="max draft tokens per lane per verify step "
                         "(0 = cfg.draft_len)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cpu only when asked for")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.device import resolve_device
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    from repro_torch.serving.engine import ServeConfig, make_engine

    device = resolve_device(args.device)
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tf.init_params(cfg, gen, device)
    serve = ServeConfig(
        slots=args.slots, max_len=args.max_len, temperature=args.temperature,
        seed=args.seed, block_size=args.block_size,
        prefill_chunk=args.prefill_chunk, paged_attn_kernel=args.paged_attn,
        speculation=args.speculation, draft_len=args.draft_len,
        device=str(device))
    engine = make_engine(cfg, params, serve)

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
          f"({total_tokens / dt:.1f} tok/s aggregate, {device})")
    peak_blocks = max(m["blocks_in_use"] for m in engine.metrics)
    print(f"steps={len(engine.metrics)} tokens/step_cov="
          f"{engine.flatness_cov():.3f} peak_blocks={peak_blocks} "
          f"shapes={engine.trace_counts}")
    if engine.draft_len:
        print(f"speculation: drafted={engine.metrics.total('drafted_tokens')} "
              f"accepted={engine.metrics.total('accepted_tokens')} "
              f"acceptance_rate={engine.acceptance_rate():.2f} "
              f"draft_len={engine.draft_len}")
    return results


if __name__ == "__main__":
    main()
