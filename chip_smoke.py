#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py [--json-out PATH]

In order, it:
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the CUDA kernels from `src/repro_torch/kernels/csrc` (one nvcc
     per source, started together) and prints the build seconds;
  3. holds each kernel against its plain PyTorch version on the card, at
     every shape the two serving paths give it (gpp_matmul at both models'
     projection shapes: bf16 x and W on its tensor-core kernel, with G in
     {None, 1, 2, 3, 4} and the FMA kernel pinned beside it, deepseek's f32
     router and every f32 shape on the split-K FMA kernel, timed at the
     router's three shapes and every f32 decode shape; both models' f32
     logits heads, f32 x against the bf16 (d, vocab) table on the FMA
     kernel, timed at the three step shapes beside the `torch.matmul` on
     the f32 table it replaced; gpp_matmul_grouped on both routes, bf16 x
     and W on its tensor-core kernel, f32 and int8 on its split-K FMA
     kernel, both timed at every phase and projection), and prints the
     largest error beside its tolerance, then the kernel's
     time (for bf16 gpp_matmul also the pinned FMA kernel's), the plain
     version's time, a library yardstick's time (`torch.matmul` /
     `torch.bmm`, f32 with TF32 off; `scaled_dot_product_attention` on
     gathered K/V or latent rows; `F.rms_norm`) and the bound (the larger
     of bytes / 3.35e12 B/s and operations / the peak rate of their type);
     it checks that the gpp_matmul repeats bit for bit on both routes and
     the grouped FMA kernel too, that a tensor-core row is the same bits
     at 1, 2, 4, 12, 16, 20 and 32 rows at every bf16 projection, the
     router's at 1, 4, 20 and 32 rows, a logits row at 1, 2, 4, 12, 16, 20
     and 32 rows on every model's table (since slice 20 also at 2 and 12
     rows, the batches of a B = 2 and a B = 12 `transformer.decode_step`)
     and a grouped FMA row at 8, 32 and 128 rows an expert, reads
     the issue-order records of gpp_matmul (the FMA route's CTA 0 across a
     tile boundary and a k-split; the tensor-core route's rank 0 over a
     k-slice of several steps), gpp_matmul_grouped (the tensor-core route
     at deepseek's decode shape, across n-tiles, and at one n-tile an
     expert, across experts; the FMA route at the decode shape in f32,
     across tiles and k-splits, and at one n-tile an expert, across three
     experts) and both tensor-core attention kernels
     back and compares them with `chunk_issue_schedule` for G in {1, 2, 4}
     (3 too on the tensor-core gpp_matmul) and the planned G, checks that
     the card holds the CTAs an SM the plans assume (both grouped routes;
     for the tensor-core gpp_matmul: every planned cluster at once, by
     cudaOccupancyMaxActiveClusters), and runs
     one full-width deepseek MoE layer in bf16 with the kernels against
     the plain versions (decode and prefill inputs, relative error <=
     1e-2); GQA / window paged attention runs its tensor-core kernel in
     bf16 (split-KV, kv_splits planned, 1, 2; head_dim 64 at qwen's three
     shapes with and without a 32-token window, 128 and 256 at decode and
     verify), the FMA kernel's bf16 instance pinned, and its FMA kernel in
     f32 (split-KV over fixed runs of pieces, kv_splits planned, 1, 2 and
     one run a piece, with its merge), timed at every bf16 shape (also by
     CUDA events over CUDA graphs at kv_splits 1, 2, 4 and planned) and at
     f32 decode (with its plan: P, kv_splits, grid); MLA paged attention
     runs its tensor-core kernel in bf16 (split-KV, kv_splits planned, 1,
     2, 8) and its FMA kernel in f32 (likewise split), is timed in both at
     decode (bf16 also at prefill and verify; both also by CUDA events over
     a CUDA graph of launches); the merge kernel they share is held against
     its plain version on the tensor-core kernels' partials and timed in
     bf16 and f32; MLA on the FMA kernel at the block sizes the
     tensor-core kernel does not take (bf16 at 8, 128 and 256 tokens, f32
     at 128 and 256; max_len 256 for 256) is held against the plain
     version at the three shapes and timed at decode; the FMA kernel's
     issue order (MLA f32 / bf16, GQA f32) is read beside the tensor-core
     kernels'; RMSNorm runs
     its row-invariant kernel at the paths' widths (512-2048, f32 and bf16,
     1-32 rows, strided rows), whose rows must be the same bits at 1, 5 and
     32 rows, at any place in the batch and at decode and verify layouts;
     and (slice 12) every attention kernel where the prefix cache puts it:
     a 32-token prefill chunk starting at 16, 48 and 80 (tensor-core GQA
     at head_dim 64 / 128 / 256 with and without a window, tensor-core
     MLA, the FMA kernel's bf16 instance at head_dim 80, f32 FMA GQA and
     MLA) and decode / verify with lanes whose tables name the same
     blocks;
  4. serves full-width qwen1.5-0.5b (random weights from a seed; 12 of
     its 24 layers since slice 13) through
     `repro_torch.serving.ServingEngine`: a warm-up run on random prompts,
     whose greedy continuations are then appended to the prompts (so the
     n-gram drafter finds drafts), bf16 with speculation off and on at
     three prompt seeds, whose greedy streams must be equal (tok/s and
     launch counts from seed 0, which must be > 0 for the path's kernels
     and 0 for the others: bf16 projections on the tensor-core gpp_matmul,
     the FMA one for the f32 logits head, one a step-function call, and
     deepseek's f32 router, one a MoE layer; GQA on the tensor-core kernel
     and its merge; RMSNorm on its kernel), one
     profiled run (device time by kernel, again only under the path's
     kernels, busy share, the time under gpp_matmul and paged attention),
     then float32 with the kernels and with their plain versions, whose
     greedy streams must be equal; with the model resident it serves
     with the prefix cache (`prefix_serving`: 4 requests sharing an
     80-token system prompt, `engine.defragment()`, 2 follow-up turns;
     prefix on == off in bf16 at three prompt seeds and in f32 with each
     token's logits row within LOGITS_RTOL, hits, the cache's invariants
     after every step, three step shapes, the same streams without the
     `defragment`) and with telemetry (`obs_run`: obs on == off, a trace
     with every request, step and the modelled kernel lanes, TTFT / TPOT,
     the utilization report, the overhead as the best of 5 interleaved
     runs, the host time of a step split into its parts);
  5. the same for deepseek-v2-lite-16b (MLA + MoE) at full width with 9
     of its 27 layers in bf16 (since slice 13; ~31 GB at full depth); its
     float32 kernel-vs-plain stream
     check runs at full width with 4 of its 27 layers (1 dense + 3 MoE),
     since full depth in f32 is 62.8 GB of weights; then, at 4 layers, it
     serves bf16 with 8- and 128-token KV blocks (the FMA MLA kernel's
     bf16 instance, counted on its own, and its merge) and f32 with 8- and
     128-token blocks, whose greedy streams must equal the plain run's;
  6. for the paged token archs of slice 11, at their published widths,
     with step 3's checks: every projection shape of qwen2-7b,
     h2o-danube-1.8b, gemma3-12b and kimi-k2 on both gpp_matmul routes
     (bf16 at the three step shapes, a row's bits equal at 4 / 20 / 32
     rows; f32 at decode; kimi's f32 router's bits at 1 / 4 / 20 / 32
     rows), their f32 logits heads, GQA attention at their heads (query
     groups 2, 4, 7 and 8; head_dim 256 with gemma3's 1024-token window
     past it at max_len 1280; danube's head_dim 80 on the FMA kernel's
     bf16 instance), the grouped kernel at kimi's 384 experts and one
     full-width kimi MoE layer (auto vs plain within 1e-2, the experts
     given no routed row); and, after step 5, it serves qwen2-7b at full
     width with 8 of its 28 layers and danube at full width and depth
     (f32 too),
     gemma3-12b at full width with 12 layers in bf16 and f32, gemma3
     also with a 1,200-token
     request past its window (bf16 spec on == off, the window group's
     blocks plateau, f32 kernel == plain), and kimi-k2 at full width with
     2 of its 61 layers in bf16 (its f32 parity stands on the CPU at
     SMOKE: 2 layers in f32 are 80 GB), each launching exactly its path's
     kernels, bf16 spec on == off at three prompt seeds (prompts of one
     token repeated, so the drafter drafts; some seed must accept drafts),
     the f32 streams on random prompts, and every f32 run's logits rows,
     one an emitted token, within LOGITS_RTOL of the plain run's; deepseek
     (step 5) and gemma3-12b also serve with the prefix cache
     (`prefix_serving`), gemma3 also two requests sharing a 1,100-token
     prefix past its window (`prefix_long_run`), and full-width
     qwen1.5-0.5b drafts for qwen2-7b and for itself (`draft_run`:
     streams equal to speculation off, drafts accepted when it drafts for
     itself, the draft forward's device time);
  7. with step 3's checks, the paper's workload,
     `kernels.ops.streamed_gemm_sequence`: 8 rounds of 4096 x 4096 bf16
     weights (256 MB) at 8 and 128 rows, at G = 1, 2, 3, 4 and the planned
     G (gpp_matmul's planner, unpinned), against the plain version, timed beside the copied simulator's
     prediction, with measured tile times fed to a `TimingCache`; the
     planned G must run within 5% of the fastest, and every serving
     shape's tensor-core plan must be the one it was (one wave, the
     deepest ring);
  8. (slice 13) with step 3's checks, gpp_matmul at every projection shape
     of the four non-paged archs (zamba2's w_in / w_bc / w_dt, N = 10240 /
     128 / 32, and w_out, K = 5120; xlstm's gates, N = 4, its sigmoid
     output gates and its contract_dims=2 output projection over 4 heads
     of 512; musicgen's gelu up; llama-3.2-vision's projections and its
     6400-row cross K / V), decode and prefill rows, bf16 and f32, the bf16
     decode shapes and the four f32 logits heads timed beside
     torch.matmul, and RMSNorm at the cross layers' 128-wide per-head
     rows; then it serves zamba2-2.7b (18 of 54 layers), xlstm-1.3b (16
     of 48) and qwen1.5-0.5b (`--engine dense`, 12 of 24) through
     `repro_torch.serving.DenseServingEngine` at full width (4 slots,
     max_len 128, 4 requests x 16
     tokens, prompts of 6 / 9 / 12 / 15 tokens, so decode runs a call a
     position group): bf16 with the kernels (warm-up, measured,
     profiled: device time by kernel and busy share) and plain, f32 with
     the kernels against plain (equal greedy streams, each emitted
     token's logits row within LOGITS_RTOL); and runs llama-3.2-vision-11b
     (4 x 32-token prompts, 1600 patch embeddings a row from the seed) and
     musicgen-large (frame embeddings from the seed, one a decode step)
     through `transformer.prefill` + 16 `decode_step` calls at full width
     and depth, bf16 and f32, with the same gates; each run launches
     exactly the path's kernels (bf16: the tensor-core gpp_matmul, its FMA
     route for the f32 logits head once a step-function call, RMSNorm; f32:
     the FMA gpp_matmul and RMSNorm; no attention or grouped kernel);
  9. (slice 14) training: the tensor-core gpp_matmul at qwen's projections
     over 4 x 1024 rows, the f32 FMA head at a 512-position chunk (2048
     rows) and the grouped tensor-core kernel at deepseek's training
     capacity, timed beside their plain versions and torch.matmul /
     torch.bmm; then qwen1.5-0.5b at full width and depth, bf16, AdamW,
     batch 4 x 1024, block remat: one loss and gradient on the kernel
     route against the plain route in bf16 (every leaf at cosine >= 0.99,
     a leaf whose exact gradient is 0 both norms under 1e-3 of the
     global) and in f32 (each leaf within 1e-3 of its scale), launching
     only gpp_matmul_tc, gpp_matmul (the f32 head) and rmsnorm,
     recomputation included, and the plain route none; 8 AdamW steps at
     lr 1e-3 descending; an async checkpoint after step 8 restored into a
     fresh tree bit for bit, a step from each with equal losses; the CLI
     (`launch.train.main`, SMOKE widths) for 4 steps with a checkpoint
     every 2, then resumed to 6; an Adafactor step; tok/s, peak memory
     and one profiled step's device time by part; then
     deepseek-v2-lite-16b at full width with 2 layers, bf16, 4 x 512: the
     same route check (the router and every expert stack among the
     leaves), the grouped kernel launched at the training capacity, the
     aux load-balance loss on both routes within 1e-5, one AdamW step;
 10. (slice 15) the layer streamer (`core.streamer`): qwen1.5-0.5b at
     full width and depth in bf16 with its 24 stacked layers resting in
     pinned host memory (617 MB), the embedding and final norm on the
     card; at 4 x 1024 and 4 x 16 tokens, resident (all on the card) and
     insitu, naive_pp and gpp at G = 2, 3, 4 and the planned rings, the
     fetches host-to-device copies on a side stream: hidden states and
     logits equal resident's bit for bit, the bytes a step flat at one
     layer, launches, the median of 5 timed passes, peak HBM; the
     host-to-device rate and `plan_stream`'s rings at the bf16 peak and at
     resident's measured compute; a remat gradient under gpp (G = 3)
     equal to resident's (`check_layer_streaming`);
 11. (slice 16) the sharded steps (`launch.steps`) on a 1x1 ("data",
     "model") mesh over NCCL (one card: every collective runs over a group
     of one rank; parity across ranks stands on gloo CPU ranks,
     tests/test_torch_dist_*.py): deepseek-v2-lite-16b at full width with
     its dense layer and 3 MoE layers, `make_prefill_step` (4 x 32,
     `_moe_shard_map`) and 16 `make_decode_step`s (`_moe_shard_map_serve`),
     at a capacity that drops no token, bf16 against the plain route (on
     the kernel run's expert choices) and f32 against the plain route and
     the mesh-less steps; qwen1.5-0.5b's
     full-width train step bit for bit the mesh-less step's;
     `_sdpa_kv_chunked` against `_sdpa` at qwen2-7b's heads, T = 4096;
     (slice 17) xlstm-1.3b's Adafactor train step (4 of 48 layers) against
     the mesh-less one, zamba2-2.7b (one superblock, B = 1) and
     llama-3.2-vision-11b (one superblock, its cross layer) through the
     prefill and decode steps (`check_sharded_steps`); (slice 19) on the
     same mesh, the steps' buffer donation (`check_donation`):
     qwen1.5-0.5b at full width and depth, `make_decode_step` at B = 12
     over a 32,768-position bf16 cache (38.65 GB), written in place (the
     step allocates under a quarter of the cache and returns the leaves it
     was given; at 16,384 positions bit for bit the functional
     `decode_step`), and its train step's peak with donation beside the
     mesh-less functional route's;
 12. (slice 18) the roofline (`check_roofline`): `python -m
     repro_torch.launch.dryrun` for qwen1.5-0.5b train_4k on the 16x16
     mesh (a fake process group of 256 ranks, in a process of its own,
     within 90 s) and `repro_torch.launch.report` on its JSON, the cell ok
     and fitting the card; meanwhile step 11's qwen train step and
     deepseek decode steps counted on meta (`roofline.count`) as that
     phase built them: the three terms on `repro_torch.launch.roofline`'s
     H100 constants, the roofline step time against the time the card
     took (the share, at most 1.05), the MFU, and the predicted peak
     beside `torch.cuda.max_memory_allocated`;
 13. (slice 20) the examples (`check_examples`), each in a process of its
     own in a temporary working directory, the kernels already built:
     `examples/torch_gpp_design_space.py`, its printout the JAX example's
     text (`DESIGN_SPACE_TEXT`) character for character;
     `torch_quickstart.py` at world size 1 (qwen1.5-0.5b SMOKE, 10 train
     steps, 8 greedy tokens); `torch_serve_batched.py`, its asserts holding
     (prefix hits, speculation == plain), its trace and metrics files
     written, at most three step shapes; `torch_train_e2e.py` at its
     default batch (16 x 256 tokens on the ~106M model, resident) for 100
     of its 300 default steps (the script's time; the full run is in
     PERF.md), its loss falling, its seconds and tok/s, then
     `--stream-mode gpp` for 20 steps (its layers in pinned host memory)
     with resident's losses bit for bit, then a run saved at 10 steps and
     resumed to 12 with the uninterrupted run's losses bit for bit; each
     run launching its path's kernels only.  The kernels at the examples'
     own shapes: every launch of the quickstart, of a second pass of the
     serve example (its streams the first pass's) and of train_e2e's two
     resumed steps is held against its plain version on the same inputs
     at the kernel gates' tolerances (`held_to_plain`), and the ~106M
     model's loss and gradient on its first batch on the kernel route
     against the plain route (`check_example_routes`, gated as step 9's
     bf16 routes);
 14. prints {"kernels": [...]} (launches by path, the examples' too) and,
     last, the device line.  Each phase's seconds are printed as it ends
     (`phase ...: N s`), the examples' too.

Any failed check raises, so the exit code is not 0.  Without CUDA, or
outside a checkout of the repo (no `src/repro_torch` beside it), it exits
with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPORT_DIR = None          # --json-out's directory: the obs trace goes there
sys.path.insert(0, str(ROOT / "src"))

# the bounds' yardstick: `main` sets HBM_BW and the bf16 peak from
# `repro_torch.launch.roofline` once it has found the checkout, so the kernel
# table's bounds and the step's roofline share read one set of constants
H100_HBM_BYTES_PER_S = None
PEAK_OPS = {"bfloat16": None, "float32": 67e12}   # dense, per type
L2_BYTES = 50 * 1024 * 1024
TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, 2e-2)}   # (atol, rtol)

D, F, H, HD = 1024, 2816, 16, 64      # qwen1.5-0.5b widths
DS_D, DS_F, DS_E, DS_H = 2048, 1408, 64, 16      # deepseek-v2-lite widths
DS_R, DS_RR, DS_NOPE, DS_F0 = 512, 64, 128, 10944  # kv_lora, rope, layer 0
SLOTS, MAX_LEN, BS, CHUNK, DRAFT = 4, 128, 16, 32, 4
PHASE_M = {"decode": SLOTS, "prefill": CHUNK, "verify": SLOTS * (DRAFT + 1)}
DRAFT_WINDOW = 16     # tokens of the draft model's forward (the engine's)
BOTH = ("bfloat16", "float32")
# gpp_matmul's (K, N, dtypes) on each serving path.  deepseek: MLA q, the
# kv down-projection (latent + rope), o; the router, f32 in every model
# dtype; the 2 shared experts (2 x 1408 wide); layer 0's dense MLP.
GPP_SHAPES = {
    "qwen1.5-0.5b": {"qkvo": (D, D, BOTH), "gate_up": (D, F, BOTH),
                     "down": (F, D, BOTH)},
    "deepseek-v2-lite-16b": {
        "q": (DS_D, DS_H * (DS_NOPE + DS_RR), BOTH),
        "dkv": (DS_D, DS_R + DS_RR, BOTH),
        "o": (DS_H * DS_NOPE, DS_D, BOTH),
        "router": (DS_D, DS_E, ("float32",)),
        "shared_gate_up": (DS_D, 2 * DS_F, BOTH),
        "shared_down": (2 * DS_F, DS_D, BOTH),
        "dense_gate_up": (DS_D, DS_F0, BOTH),
        "dense_down": (DS_F0, DS_D, BOTH)},
}
# the paged token archs ported in slice 11, at their published widths
# (configs/): (d_model, heads, kv heads, head_dim, d_ff, vocab)
NEW_ARCHS = {"qwen2-7b": (3584, 28, 4, 128, 18944, 152064),
             "h2o-danube-1.8b": (2560, 32, 8, 80, 6912, 32000),
             "gemma3-12b": (3840, 16, 8, 256, 15360, 262144),
             "kimi-k2-1t-a32b": (7168, 64, 8, 128, 18432, 163840)}
KIMI_E, KIMI_F = 384, 2048          # kimi-k2's routed experts and their d_ff
# their gpp_matmul shapes: q, k / v, o, the MLP (kimi: layer 0's dense MLP,
# the shared expert, the f32 router); f32 at decode only (the f32 serving
# runs then hold every shape, stream against stream)
GPP_SHAPES.update({
    arch: {"q": (d, h * hd, BOTH), "kv": (d, kv * hd, BOTH),
           "o": (h * hd, d, BOTH), "gate_up": (d, f, BOTH),
           "down": (f, d, BOTH)}
    for arch, (d, h, kv, hd, f, _) in NEW_ARCHS.items()})
GPP_SHAPES["kimi-k2-1t-a32b"].update({
    "shared_gate_up": (7168, KIMI_F, BOTH),
    "shared_down": (KIMI_F, 7168, BOTH),
    "router": (7168, KIMI_E, ("float32",))})


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def time_ms(fn, argsets, iters: int = 100) -> float:
    """Mean ms per call, cycling through `argsets` (distinct buffers whose
    total exceeds the L2 cache, so each call finds its inputs cold, as a
    layer of the real path does)."""
    import torch
    for a in argsets:
        fn(*a)
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(iters):
        fn(*argsets[i % len(argsets)])
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(fn, argsets, name=None, iters: int = 50):
    """Device time per call: the summed duration of the kernels the calls
    ran (only those whose name contains `name`, or one of the names of a
    tuple, if given), from a torch.profiler (CUPTI) trace.  A trace that
    holds no such event is taken again, up to 3 times (a trace now and
    then comes back empty); None when all are empty, and the caller then
    keeps the CUDA-event time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for a in argsets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    names = (name,) if isinstance(name, str) else name
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                fn(*argsets[i % len(argsets)])
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and (names is None or any(n in e.name for n in names)))
        if us > 0:
            return us / iters / 1e3
    return None


def measure(fn, argsets, name=None, iters: int = 100
            ) -> "tuple[float, float]":
    """(device ms, wall ms) per call, over `iters` calls (the device time
    over half as many).  The wall time (CUDA events around back-to-back
    calls) includes the host's launch cost where that is the larger; the
    device time is what the card spent."""
    wall = time_ms(fn, argsets, iters)
    dev = device_ms(fn, argsets, name, max(1, iters // 2))
    return (dev if dev is not None else wall), wall


def graph_ms(fn, argsets, iters: int = 50) -> float:
    """Mean ms per call from CUDA events around the replay of a CUDA graph
    of `iters` calls: the card's time for the calls and the gaps between
    them, without the host's launch cost (which, for a kernel of a few
    microseconds, is what back-to-back calls from Python measure)."""
    import torch
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):       # warm-up: attributes, scratch
        for a in argsets:
            fn(*a)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            fn(*argsets[i % len(argsets)])
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(4):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (4 * iters)


def copies_for(nbytes: int) -> int:
    return max(1, min(64, math.ceil(2 * L2_BYTES / max(1, nbytes))))


def bound(nbytes: float, ops: float, dtype: str) -> "tuple[float, str]":
    t_b = nbytes / H100_HBM_BYTES_PER_S
    t_o = ops / PEAK_OPS[dtype]
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


# ---------------------------------------------------------------------------
# kernel 1: gpp_matmul
# ---------------------------------------------------------------------------

def gpp_case(M, K, N, dtype, *, act=None, bias=False, w_int8=False, G=None,
             route=None, seed=0):
    """One gpp_matmul comparison on the card; returns the max abs error.
    bf16 x and W must launch the tensor-core kernel (unless `route` pins
    the FMA one), anything else the FMA kernel."""
    import torch
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels.ref import dense_ref
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, K, generator=g, device="cuda").to(dt)
    if w_int8:
        w = torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                          dtype=torch.int8)
        scale = torch.rand(N, generator=g, device="cuda") * 2e-3
    else:
        w = (torch.randn(K, N, generator=g, device="cuda") * 0.02).to(dt)
        scale = None
    b = (torch.randn(N, generator=g, device="cuda") * 0.1).to(dt) \
        if bias else None
    want = route or gm.gpp_route(x.dtype, w.dtype)
    before = (gm.launches_tc.n, gm.launches.n)
    y = gm.gpp_matmul(x, w, bias=b, w_scale=scale, activation=act,
                      num_bufs=G, route=route)
    ran = (gm.launches_tc.n - before[0], gm.launches.n - before[1])
    check(ran == ((1, 0) if want == "tc" else (0, 1)),
          f"gpp_matmul {dtype} x {w.dtype} W took the wrong kernel {ran}")
    ref = dense_ref(x, w, bias=b, w_scale=scale, activation=act)
    torch.cuda.synchronize()
    err = (y.float() - ref.float()).abs()
    atol, rtol = TOL[dtype]
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    check(bool(torch.isfinite(y.float()).all()), "gpp_matmul non-finite")
    check(ok, f"gpp_matmul {M}x{K}x{N} {dtype} act={act} bias={bias} "
              f"int8={w_int8} G={G} route={want}: max err "
              f"{float(err.max())}")
    return float(err.max())


def gpp_time(M, K, N, dtype):
    """Kernel / plain / torch.matmul times of an (M,K)@(K,N) product with
    no bias or activation (the up projection), and its bound.  bf16 times
    the tensor-core route and, in the same call, the FMA route pinned;
    f32 the split-K FMA route, also by CUDA events over a CUDA graph of
    launches (`graph_ms`, with torch.matmul's beside it): a launch of a few
    microseconds is shorter than the host's cost of issuing one."""
    import torch
    from repro_torch.kernels.gpp_matmul import gpp_matmul
    from repro_torch.kernels.ref import dense_ref
    dt = getattr(torch, dtype)
    es = torch.tensor([], dtype=dt).element_size()
    n = copies_for(K * N * es)
    g = torch.Generator(device="cuda").manual_seed(1)
    sets = [((torch.randn(M, K, generator=g, device="cuda")).to(dt),
             (torch.randn(K, N, generator=g, device="cuda") * 0.02).to(dt))
            for _ in range(n)]
    out = {}
    if dtype == "bfloat16":
        out["ms"], out["wall_ms"] = measure(
            lambda x, w: gpp_matmul(x, w), sets,
            KERNEL_NAMES["gpp_matmul_tc"])
        out["fma_ms"], out["fma_wall_ms"] = measure(
            lambda x, w: gpp_matmul(x, w, route="fma"), sets,
            KERNEL_NAMES["gpp_matmul"])
    else:
        out["ms"], out["wall_ms"] = measure(
            lambda x, w: gpp_matmul(x, w), sets, KERNEL_NAMES["gpp_matmul"])
        out["graph_ms"] = graph_ms(lambda x, w: gpp_matmul(x, w), sets)
        out["library_graph_ms"] = graph_ms(torch.matmul, sets)
    out["plain_ms"], out["plain_wall_ms"] = measure(
        lambda x, w: dense_ref(x, w), sets)
    out["library_ms"], out["library_wall_ms"] = measure(
        lambda x, w: torch.matmul(x, w), sets)
    out["bound_ms"], out["bound_by"] = bound((M * K + K * N + M * N) * es,
                                             2.0 * M * K * N, dtype)
    return out


# the f32 logits heads: (d_model, vocab) of each model's table, and the
# rows a step function's head takes (prefill: its chunk's last row)
HEADS = {"qwen1.5-0.5b": (D, 151936), "deepseek-v2-lite-16b": (DS_D, 102400),
         **{arch: (w[0], w[5]) for arch, w in NEW_ARCHS.items()}}
HEAD_M = {"prefill": 1, "decode": SLOTS, "verify": SLOTS * (DRAFT + 1)}
# rows a decode step brings beside the engine's step shapes: one request,
# the B = 2 and B = 12 decodes of `transformer.decode_step` (the donation
# phase's B), held by the row-invariance gates of the tensor-core
# gpp_matmul and the f32 heads
DECODE_ROWS = (1, 2, 12)


def head_time(M, K, N):
    """The f32 logits head at one step shape: f32 x (M, K) against the
    bf16 (K, N) serving copy of the table on the FMA route of gpp_matmul
    (`kernels.ops.dense`), against what it replaced, `torch.matmul` of f32
    x and the f32 table's transpose (the cached f32 copy), and the plain
    version; the bound reads the bf16 table once."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import dense_ref
    g = torch.Generator(device="cuda").manual_seed(2)
    sets = []
    for _ in range(copies_for(K * N * 2)):
        table = (torch.randn(N, K, generator=g, device="cuda")
                 * 0.02).bfloat16()
        sets.append((torch.randn(M, K, generator=g, device="cuda"),
                     table.t().contiguous(), table.float()))
    out = {}
    out["ms"], out["wall_ms"] = measure(lambda x, wt, _: ops.dense(x, wt),
                                        sets, KERNEL_NAMES["gpp_matmul"])
    out["library_ms"], out["library_wall_ms"] = measure(
        lambda x, _, t32: x @ t32.t(), sets)
    out["plain_ms"], _ = measure(lambda x, wt, _: dense_ref(x, wt), sets)
    out["bound_ms"], out["bound_by"] = bound(
        M * K * 4 + K * N * 2 + M * N * 4, 2.0 * M * K * N, "float32")
    del sets
    torch.cuda.empty_cache()
    return out


def check_head(report):
    """The f32 logits head of both models on the FMA route: a row's bits
    equal at 1, 2, 4, 12, 16, 20 and 32 rows (and against the f32 table), within 2e-4
    of the plain version; timed at the three step shapes beside the
    `torch.matmul` it replaced."""
    import torch
    from repro_torch.core.schedule import plan_matmul_fma_sm90
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import dense_ref
    rows = []
    for arch, (K, N) in HEADS.items():
        g = torch.Generator(device="cuda").manual_seed(3)
        table = (torch.randn(N, K, generator=g, device="cuda")
                 * 0.02).bfloat16()
        table_t = table.t().contiguous()
        x = torch.randn(32, K, generator=g, device="cuda")
        fma = gm.launches.n
        y = ops.dense(x, table_t)
        check(gm.launches.n == fma + 1, f"{arch} head: not the FMA route")
        ref = dense_ref(x, table_t)
        err = float((y - ref).abs().max())
        check(bool(torch.isfinite(y).all())
              and bool(((y - ref).abs() <= 2e-4 + 2e-4 * ref.abs()).all()),
              f"{arch} head: max err {err}")
        by_m = {M: ops.dense(x[:M], table_t) for M in (
            *DECODE_ROWS, SLOTS, DRAFT_WINDOW, HEAD_M["verify"])}
        check(all(torch.equal(v, y[:M]) for M, v in by_m.items()),
              f"{arch} head: a logits row's bits depend on the batch")
        check(torch.equal(ops.dense(x[:SLOTS], table.float().t()
                                    .contiguous()), y[:SLOTS]),
              f"{arch} head: the bf16 table does not give its f32 copy's "
              "bits")
        del table, table_t
        torch.cuda.empty_cache()
        print(f"logits head {arch} {K}x{N}: a row's bits equal at "
              f"{sorted(by_m) + [32]} rows; bf16 table == its f32 copy; "
              f"max_abs_err={err:.3g}", flush=True)
        for phase, M in HEAD_M.items():
            plan = plan_matmul_fma_sm90(M, K, N, w_itemsize=2)
            row = {"arch": arch, "phase": phase, "M": M, "K": K, "N": N,
                   "max_abs_err": err,
                   "plan": {"block_m": plan.block_m,
                            "block_k": plan.block_k,
                            "num_bufs": plan.num_bufs, "grid": plan.grid,
                            "max_segs": plan.max_segs},
                   **head_time(M, K, N)}
            rows.append(row)
            print(f"logits head {arch} {phase:7s} {M}x{K}x{N} (f32 x, bf16 "
                  f"table): ms={row['ms']:.4f} torch.matmul (f32 table) "
                  f"library_ms={row['library_ms']:.4f} plain_ms="
                  f"{row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']}) wall_ms={row['wall_ms']:.4f} "
                  f"plan={row['plan']}", flush=True)
    report["logits_head"] = rows
    return rows


def check_gpp(report):
    import torch
    from repro_torch.core.schedule import (plan_matmul_fma_sm90,
                                           plan_matmul_tc_sm90)
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels.ref import ACTIVATION_IDS, chunk_issue_schedule
    rows = []
    for path, shapes in GPP_SHAPES.items():
        new = path in NEW_ARCHS
        # qwen1.5-0.5b is also the draft model: its (1, 16) window
        phases = dict(PHASE_M, **({"draft": DRAFT_WINDOW}
                                  if path == "qwen1.5-0.5b" else {}))
        for phase, M in phases.items():
            for name, (K, N, dtypes) in shapes.items():
                for dtype in dtypes:
                    bf16 = dtype == "bfloat16"
                    # slice 11's archs: f32 projections at decode, planned
                    # G (their f32 serving runs hold the rest); timed at
                    # decode in the path's own dtype
                    if new and not bf16 and phase != "decode" \
                            and name != "router":
                        continue
                    err = max(gpp_case(M, K, N, dtype, G=G)
                              for G in ((None, 1, 2, 3, 4) if bf16
                                        else (None,) if new
                                        else (None, 1, 2, 4)))
                    row = {"path": path, "phase": phase, "proj": name,
                           "M": M, "K": K, "N": N, "dtype": dtype,
                           "max_abs_err": err, "tol": TOL[dtype],
                           "route": "tc" if bf16 else "fma"}
                    if bf16:    # the FMA route still takes bf16 (pinned)
                        row["fma_max_abs_err"] = gpp_case(M, K, N, dtype,
                                                          route="fma")
                        plan = plan_matmul_tc_sm90(M, K, N)
                        row["plan"] = {
                            "block_m": plan.block_m,
                            "block_n": plan.block_n,
                            "block_k": plan.block_k,
                            "cluster": plan.cluster,
                            "num_bufs": plan.num_bufs, "ctas": plan.ctas,
                            "steps": max(plan.cta_steps(r)
                                         for r in range(plan.cluster))}
                        # every planned cluster resident at once
                        row["max_clusters"] = gm.tc_max_clusters(plan)
                        check(row["max_clusters"] >= plan.tiles,
                              f"gpp_matmul_tc {M}x{K}x{N}: the card holds "
                              f"{row['max_clusters']} clusters of "
                              f"{plan.cluster}, planned {plan.tiles}")
                    else:
                        plan = plan_matmul_fma_sm90(M, K, N, w_itemsize=4)
                        row["plan"] = {
                            "block_m": plan.block_m,
                            "block_k": plan.block_k,
                            "num_bufs": plan.num_bufs, "grid": plan.grid,
                            "max_segs": plan.max_segs}
                    # the path's own dtype, and every f32 decode shape
                    if (phase == "decode" and dtype == dtypes[0] if new
                            else dtype == dtypes[0] or phase == "decode"):
                        row.update(gpp_time(M, K, N, dtype))
                    rows.append(row)
                    print(f"gpp_matmul {path} {phase:7s} {name:14s} "
                          f"{M}x{K}x{N} {dtype} ({row['route']}): "
                          f"max_abs_err={err:.3g} (atol,rtol)={TOL[dtype]}"
                          + (f" ms={row['ms']:.4f}"
                             + (f" fma_ms={row['fma_ms']:.4f}" if bf16
                                else f" graph_ms kernel / matmul="
                                f"{row['graph_ms']:.4f} / "
                                f"{row['library_graph_ms']:.4f}")
                             + f" plain_ms={row['plain_ms']:.4f} library_ms="
                             f"{row['library_ms']:.4f} bound_ms="
                             f"{row['bound_ms']:.4f} ({row['bound_by']})"
                             f" wall_ms={row['wall_ms']:.4f}"
                             if "ms" in row else "")
                          + f" plan={row['plan']}", flush=True)
    # epilogue variants at the paths' projection shapes, by route (bf16 x
    # and W: tensor cores; f32, or int8 W: FMA)
    extra = {"tc": [], "fma": []}
    for act in ACTIVATION_IDS:
        if act is None:
            continue
        for dtype in BOTH:
            r = "tc" if dtype == "bfloat16" else "fma"
            extra[r].append(gpp_case(SLOTS, D, F, dtype, act=act, bias=True))
            extra[r].append(gpp_case(CHUNK, DS_F0, DS_D, dtype, act=act,
                                     bias=True))
    for dtype in BOTH:
        r = "tc" if dtype == "bfloat16" else "fma"
        extra[r].append(gpp_case(SLOTS, DS_D, DS_F0, dtype, act="silu"))
        extra["fma"].append(gpp_case(CHUNK, D, D, dtype, w_int8=True,
                                     act="silu"))
        extra["fma"].append(gpp_case(SLOTS, F, D, dtype, w_int8=True, G=1))
        # ragged M/K/N: 2002-byte bf16 rows take the narrower copies
        extra[r].append(gpp_case(7, 1000, 1001, dtype, bias=True,
                                 act="gelu"))
        extra[r].append(gpp_case(37, 333, 130, dtype, G=4))
        extra[r].append(gpp_case(200, 1000, 1001, dtype, G=3, act="tanh"))
    print("gpp_matmul epilogue/int8/ragged cases: "
          + ", ".join(f"{r} {len(v)} ok, max_abs_err={max(v):.3g}"
                      for r, v in extra.items()))
    # split tiles are summed in a fixed order: bf16 (tensor cores) and f32
    # (FMA: the router, a wide projection) repeat bit for bit
    g = torch.Generator(device="cuda").manual_seed(9)
    for M, K, N, dt in ((SLOTS, F, D, torch.bfloat16),
                        (CHUNK, DS_F0, DS_D, torch.bfloat16),
                        (SLOTS, DS_D, DS_E, torch.float32),
                        (CHUNK, DS_F0, DS_D, torch.float32)):
        x = torch.randn(M, K, generator=g, device="cuda").to(dt)
        w = (torch.randn(K, N, generator=g, device="cuda") * 0.02).to(dt)
        first = gm.gpp_matmul(x, w, activation="silu")
        check(all(torch.equal(gm.gpp_matmul(x, w, activation="silu"), first)
                  for _ in range(3)),
              f"gpp_matmul {M}x{K}x{N} {dt} is not bitwise repeatable")
    print("gpp_matmul bitwise repeatable over 4 runs at "
          f"{SLOTS}x{F}x{D} and {CHUNK}x{DS_F0}x{DS_D} (bf16, tensor cores), "
          f"{SLOTS}x{DS_D}x{DS_E} and {CHUNK}x{DS_F0}x{DS_D} (f32, FMA)")
    # a row's bits do not depend on the batch it rides in: a tensor-core
    # row at 1, 2 and 12 (`decode_step`'s batches), 4 (decode), 16 (the
    # draft window), 20 (verify) and 32 (prefill) rows at every bf16
    # projection of every path (the k-slices and k-groups come from K and
    # N alone), then the router at 1,
    # 4 (decode), 20 (verify) and 32 (prefill) rows, its weight as stored
    # (bf16, widened in the kernel) and as its f32 copy, which must agree
    tc_proj = sorted({(K, N) for shapes in GPP_SHAPES.values()
                      for K, N, dtypes in shapes.values()
                      if "bfloat16" in dtypes})
    tc_rows = sorted({*DECODE_ROWS, SLOTS, DRAFT_WINDOW, PHASE_M["verify"]})
    for K, N in tc_proj:
        x = torch.randn(CHUNK, K, generator=g, device="cuda").bfloat16()
        w = (torch.randn(K, N, generator=g, device="cuda")
             * 0.02).bfloat16()
        y = gm.gpp_matmul(x, w, activation="silu")
        check(all(torch.equal(gm.gpp_matmul(x[:M], w, activation="silu"),
                              y[:M]) for M in tc_rows),
              f"gpp_matmul_tc {K}x{N}: a row's bits depend on the batch")
    print(f"gpp_matmul_tc: a row's bits equal at "
          f"{' / '.join(map(str, tc_rows))} / {CHUNK} rows at all "
          f"{len(tc_proj)} bf16 projections")
    for K, N in ((DS_D, DS_E), (7168, KIMI_E)):     # deepseek's, kimi's
        x = torch.randn(CHUNK, K, generator=g, device="cuda")
        w = (torch.randn(K, N, generator=g, device="cuda") * 0.02).bfloat16()
        rows_by_m = {M: gm.gpp_matmul(x[:M], w) for M in (1, SLOTS,
                                                          PHASE_M["verify"],
                                                          CHUNK)}
        check(all(torch.equal(rows_by_m[CHUNK][:M], y)
                  for M, y in rows_by_m.items()),
              f"the router {K}x{N}: a row's bits depend on the batch")
        check(torch.equal(gm.gpp_matmul(x, w.float()), rows_by_m[CHUNK]),
              f"the router {K}x{N}: the bf16 weight does not give its f32 "
              "copy's bits")
        print(f"gpp_matmul router {K}x{N}: a row's bits equal at "
              f"{sorted(rows_by_m)} rows; bf16 W == its f32 copy")
    # the generalized ping-pong issue order survived the port: the FMA
    # route (pinned on bf16) over CTA 0's planned run, and over a run
    # across a tile boundary (2 CTAs pinned) and at the router's k-split;
    # the tensor-core route over rank 0's k-slice of several steps, which
    # rank 1 continues (a cluster of 2 at 128-row steps pinned: 8 steps;
    # layer 0's down projection as planned)
    orders = 0
    x = torch.randn(SLOTS, D, device="cuda").bfloat16()
    w = (torch.randn(D, D, device="cuda") * 0.02).bfloat16()
    for G in (1, 2, 4):
        got, num_k, g_used, C = gm.issue_order(x, w, G, route="fma")
        check(g_used == G, f"ring depth {g_used} != {G}")
        check(got == chunk_issue_schedule(num_k, G, C),
              f"fma issue order differs at G={G}")
        orders += 1
        print(f"gpp_matmul (fma) issue order G={G} C={C} steps={num_k}: "
              f"{sum(len(v) for v in got.values())} chunk issues == "
              "chunk_issue_schedule")
    for (M, K, N), grid in (((SLOTS, 512, 192), 2), ((SLOTS, DS_D, DS_E),
                                                      None)):
        x = torch.randn(M, K, device="cuda")
        w = torch.randn(K, N, device="cuda") * 0.02
        for G in (None, 1, 2, 4):
            got, steps, g_used, C = gm.issue_order(x, w, G, grid=grid)
            plan = plan_matmul_fma_sm90(M, K, N, w_itemsize=4, num_bufs=G,
                                        grid=grid)
            tiles = {plan.unit(u)[0] for u in plan.cta_units(0)}
            check(len(plan.segments(max(tiles))) > 1
                  and len(tiles) == (2 if grid else 1),
                  "the fma record's run crosses no tile or split boundary")
            check(G is None or g_used == G, f"ring depth {g_used} != {G}")
            check(got == chunk_issue_schedule(steps, g_used, C),
                  f"fma issue order differs at {M}x{K}x{N} G={G}")
            orders += 1
            print(f"gpp_matmul (fma) issue order {M}x{K}x{N} grid="
                  f"{plan.grid} G={g_used} (asked {G}) C={C} steps={steps} "
                  f"over tiles {sorted(tiles)}, tile {max(tiles)} in "
                  f"{len(plan.segments(max(tiles)))} segments: "
                  f"{sum(len(v) for v in got.values())} chunk issues == "
                  "chunk_issue_schedule")
    for (M, K, N), pins in (((SLOTS, 2048, 1024),
                             dict(cluster=2, block_k=128)),
                            ((SLOTS, DS_F0, DS_D), {})):
        x = torch.randn(M, K, device="cuda").bfloat16()
        w = (torch.randn(K, N, device="cuda") * 0.02).bfloat16()
        for G in (None, 1, 2, 3, 4):
            got, steps, g_used, C = gm.issue_order(x, w, G, **pins)
            plan = plan_matmul_tc_sm90(M, K, N, num_bufs=G, **pins)
            check(steps == plan.cta_steps(0) >= 5 and plan.cluster > 1,
                  "the tc record's k-slice is short or unsplit")
            check(G is None or g_used == G, f"ring depth {g_used} != {G}")
            check(got == chunk_issue_schedule(steps, g_used, C),
                  f"tc issue order differs at {M}x{K}x{N} G={G}")
            orders += 1
            print(f"gpp_matmul_tc issue order {M}x{K}x{N} cluster="
                  f"{plan.cluster} block_k={plan.block_k} G={g_used} (asked "
                  f"{G}) C={C} steps={steps} of {plan.num_k}: "
                  f"{sum(len(v) for v in got.values())} chunk issues == "
                  "chunk_issue_schedule")
    err = {r: max(v + [row["max_abs_err"] for row in rows
                       if row["route"] == r]) for r, v in extra.items()}
    report["gpp_matmul"] = {"shapes": rows,
                            "extra_cases": sum(map(len, extra.values())),
                            "max_abs_err_by_route": err,
                            "issue_orders": orders}
    return rows, err


# ---------------------------------------------------------------------------
# kernel 2: paged attention
# ---------------------------------------------------------------------------

def share_tables(tables, positions, S, bs=BS):
    """Make every lane after the first name lane 0's physical blocks for
    the blocks both hold before their last one (a shared prefix, as the
    prefix cache maps it: read-only, the lane's own last block apart)."""
    n0 = (positions[0] + S - 1) // bs + 1
    for b, p in enumerate(positions[1:], 1):
        k = min(n0, (p + S - 1) // bs + 1) - 1
        tables[b, :k] = tables[0, :k]
    return tables


def pa_inputs(B, S, positions, dtype, *, nb, seed=0, hd=HD, kvh=H, heads=H,
              max_len=MAX_LEN, share=False):
    import torch
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    mb = max_len // BS
    q = torch.randn(B, S, heads, hd, generator=g, device="cuda").to(dt)
    k = (torch.randn(nb, BS, kvh, hd, generator=g, device="cuda") * 0.5
         ).to(dt)
    v = (torch.randn(nb, BS, kvh, hd, generator=g, device="cuda") * 0.5
         ).to(dt)
    perm = torch.randperm(nb - 1, generator=g, device="cuda") + 1
    tables = torch.zeros(B, mb, dtype=torch.int32, device="cuda")
    used = 0
    for b, p in enumerate(positions):
        nblk = (p + S - 1) // BS + 1
        tables[b, :nblk] = perm[used:used + nblk].int()
        used += nblk
    if share:
        share_tables(tables, positions, S)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    return q, k, v, tables, pos


def pa_work(positions, S, window, es, *, heads=H, kvh=H, hd=HD,
            max_len=MAX_LEN):
    """(bytes, operations) this call's data needs: each visible K/V row
    (kvh heads) read once, q / tables / positions read and the output
    written once; 2 * hd operations per (query head row, visible key) for
    q.k and again for p.v."""
    keys = set()
    pairs = 0
    for b, p in enumerate(positions):
        for s in range(S):
            lo = 0 if window is None else max(0, p + s - window + 1)
            pairs += p + s - lo + 1
            keys.update((b, t) for t in range(lo, p + s + 1))
    B = len(positions)
    nbytes = (2 * len(keys) * kvh * hd * es + 2 * B * S * heads * hd * es
              + B * (max_len // BS) * 4 + B * 4)
    return nbytes, 4.0 * pairs * heads * hd


PA_CASES = [
    ("decode", SLOTS, 1, [5, 17, 40, 100]),
    ("prefill", 1, CHUNK, [37]),             # unaligned chunk start
    ("verify", SLOTS, DRAFT + 1, [3, 30, 64, 90]),
]


# slice 11's GQA shapes: heads, kv heads, head_dim, window, max_len and
# step cases.  gemma3-12b's window layers serve a 1,200-token request
# (max_len 1280: 80 blocks, 8 runs of 10), so its cases sit past the
# 1024-token window, whose first runs are then wholly behind it; its
# global layers (no window) read the same pools.  danube's 4096-token
# window does not bind under 128 tokens: a 32-token window stands in.
LONG_CASES = [("decode", SLOTS, 1, [5, 300, 1100, 1250]),
              ("prefill", 1, CHUNK, [1100]),
              ("verify", SLOTS, DRAFT + 1, [3, 600, 1030, 1240])]
NEW_PA = {"qwen2-7b": (28, 4, 128, None, MAX_LEN, PA_CASES),
          "kimi-k2-1t-a32b": (64, 8, 128, None, MAX_LEN, PA_CASES),
          "gemma3-12b": (16, 8, 256, 1024, 1280, LONG_CASES),
          "gemma3-12b global": (16, 8, 256, None, 1280, LONG_CASES[:1]),
          "h2o-danube-1.8b": (32, 8, 80, 4096, MAX_LEN, PA_CASES),
          "h2o-danube-1.8b +window": (32, 8, 80, 32, MAX_LEN, PA_CASES)}


def fma_times(row, fn, sets, name, plan, launch, q2_sets):
    """The FMA route's times into `row`: the profiler's device time of the
    kernel and its merge (summed, then each alone), the CUDA-event time of
    a graph of launches (`launch` on pre-scaled q rows) and the plan (P,
    kv_splits, the grid, the ring, the shared memory)."""
    names = (name, KERNEL_NAMES["paged_attention_merge"])
    row["ms"], row["wall_ms"] = measure(fn, sets, names)
    row["kernel_ms"] = device_ms(fn, sets, name)
    row["merge_ms"] = (device_ms(fn, sets, names[1])
                       if plan.kv_splits > 1 else 0.0)
    row["graph_ms"] = graph_ms(launch, q2_sets)
    row["plan"] = {"piece": plan.piece, "kv_splits": plan.kv_splits,
                   "grid": list(plan.grid), "ctas": plan.ctas,
                   "num_bufs": plan.num_bufs, "smem_bytes": plan.smem_bytes}


def pa_case(name, B, S, positions, dtype, *, window=None, timed=False,
            hd=HD, kvh=H, heads=H, max_len=MAX_LEN, share=False):
    """One GQA / window comparison on the card, at every ring depth: bf16
    must launch the tensor-core kernel (kv_splits planned, 1 and 2; its
    merge with more than one run), f32 the FMA kernel (kv_splits planned,
    1, 2 and one run a piece; its merge likewise); bf16 also holds the FMA
    kernel's bf16 instance (pinned) and the merge kernel alone against
    their plain versions.  `timed` adds the kernel's device time (with its
    merge; bf16 also the FMA kernel pinned beside it), the plain
    version's, SDPA's on gathered K/V, the bound and the CUDA-event time of
    a graph of launches (tensor cores: at kv_splits 1, 2, 4 and planned).
    A bf16 head_dim the tensor-core plan does not take (80) must launch
    the FMA kernel's bf16 instance, at the same splits as f32."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.core.schedule import (plan_paged_attn_fma_sm90,
                                           plan_paged_attn_gqa_tc_sm90)
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attn_ref
    mb = max_len // BS
    nb = SLOTS * mb + 1
    shape = dict(hd=hd, kvh=kvh, heads=heads, max_len=max_len)
    q, k, v, tables, pos = pa_inputs(B, S, positions, dtype, nb=nb,
                                     share=share, **shape)
    kw = dict(num_kv_heads=kvh, scale=1.0 / math.sqrt(hd), window=window)
    ref = paged_attn_ref(q, k, v, tables, pos, **kw)
    route = pa.attention_route(q.dtype, False, BS, hd, hd)
    tc = route == "gqa_tc"
    check(tc == (dtype == "bfloat16" and hd in (64, 128, 256)),
          f"gqa {name} {dtype} hd {hd}: route {route}")
    counts = (pa.launches_tc, pa.launches, pa.launches_bf16)
    fma_counts = (0, 1, 0) if dtype == "float32" else (0, 0, 1)
    errs = []

    def run(want, **extra):
        before = [c.n for c in counts]
        out = pa.paged_attention(q, k, v, tables, pos, **kw, **extra)
        torch.cuda.synchronize()
        ran = tuple(c.n - n for c, n in zip(counts, before))
        check(ran == want, f"gqa {name} {dtype} {extra} took the wrong "
                           f"kernel: {ran}")
        check(tuple(out.shape) == (B, S, heads, hd), f"gqa {name}: shape")
        check(bool(torch.isfinite(out.float()).all()),
              f"gqa {name}: non-finite")
        return float((out.float() - ref.float()).abs().max())

    fplan = plan_paged_attn_fma_sm90(
        batch=B, kv_heads=kvh, rows=heads // kvh * S, block_size=BS,
        max_blocks=mb, width=hd, kv_itemsize=q.element_size())
    for G in (None, 1, 2, 4):
        for ks in ((None, 1, 2) if tc else (None, 1, 2, fplan.pieces)):
            errs.append(run((1, 0, 0) if tc else fma_counts, num_bufs=G,
                            kv_splits=ks))
    err = max(errs)
    atol, _ = TOL[dtype]
    check(err <= atol, f"paged_attention {name} {dtype} hd {hd}: max err "
                       f"{err}")
    row = {"case": name, "B": B, "S": S, "positions": positions,
           "window": window, "dtype": dtype, "head_dim": hd, "heads": heads,
           "kv_heads": kvh, "max_len": max_len, "route": route,
           "max_abs_err": err, "tol": atol}
    if tc:
        row["fma_max_abs_err"] = run((0, 0, 1), route="gqa")
        check(row["fma_max_abs_err"] <= atol,
              f"gqa {name}: the FMA kernel's bf16 instance, max err "
              f"{row['fma_max_abs_err']}")
        plan = plan_paged_attn_gqa_tc_sm90(
            batch=B, kv_heads=kvh, rows=heads // kvh * S, block_size=BS,
            max_blocks=mb, head_dim=hd)
        row["merge_max_abs_err"] = gqa_merge_case(q, k, v, tables, pos, kw,
                                                  plan)
        row["plan"] = {"kv_splits": plan.kv_splits, "num_bufs":
                       plan.num_bufs, "ctas": plan.ctas,
                       "ctas_per_sm": plan.ctas_per_sm}
        row["ctas_per_sm"] = pa.gqa_tc_ctas_per_sm(plan)
        check(row["ctas_per_sm"] >= plan.ctas_per_sm,
              f"gqa {name}: the card holds {row['ctas_per_sm']} CTAs an SM, "
              f"planned {plan.ctas_per_sm}")
    if timed:
        es = q.element_size()
        n = copies_for(2 * k.numel() * es)
        sets = [pa_inputs(B, S, positions, dtype, nb=nb, seed=i, **shape)
                for i in range(n)]

        def call(**extra):
            return lambda q, k, v, t, p: pa.paged_attention(
                q, k, v, t, p, **kw, **extra)

        if tc:
            names = (KERNEL_NAMES["paged_attention_tc"],
                     KERNEL_NAMES["paged_attention_merge"])
            row["ms"], row["wall_ms"] = measure(call(), sets, names)
            row["kernel_ms"] = device_ms(call(), sets, names[0])
            row["merge_ms"] = (device_ms(call(), sets, names[1])
                               if plan.kv_splits > 1 else 0.0)
            row["fma_ms"], row["fma_wall_ms"] = measure(
                call(route="gqa"), sets,
                (KERNEL_NAMES["paged_attention"],
                 KERNEL_NAMES["paged_attention_merge"]))
            rows_q = [(pa._q_rows(q_, kw["scale"], kvh, q_.dtype), k_, v_,
                       t_, p_) for q_, k_, v_, t_, p_ in sets]
            row["graph_ms_by_splits"] = {}
            for ks in (1, 2, 4, None):
                p_ks = plan_paged_attn_gqa_tc_sm90(
                    batch=B, kv_heads=kvh, rows=heads // kvh * S,
                    block_size=BS, max_blocks=mb, head_dim=hd, kv_splits=ks)
                row["graph_ms_by_splits"][
                    "planned" if ks is None else str(ks)] = graph_ms(
                    lambda q2, k_, v_, t_, p_, p_ks=p_ks: pa._launch_gqa_tc(
                        q2, k_, v_, t_, p_, p_ks, S=S, window=window),
                    rows_q)
            row["graph_ms"] = row["graph_ms_by_splits"]["planned"]
        else:
            fma_times(row, call(), sets, KERNEL_NAMES["paged_attention"],
                      fplan, lambda q2, k_, v_, t_, p_: pa._launch_fma(
                          q2, k_, v_, t_, p_, fplan, S=S, window=window),
                      [(pa._q_rows(q_, kw["scale"], kvh, q_.dtype), k_, v_,
                        t_, p_) for q_, k_, v_, t_, p_ in sets])
        row["plain_ms"], row["plain_wall_ms"] = measure(
            lambda q, k, v, t, p: paged_attn_ref(q, k, v, t, p, **kw), sets)
        # yardstick: SDPA over K/V gathered through the tables beforehand
        # (each KV head repeated for its query group)
        T = max_len
        kpos = torch.arange(T, device="cuda")
        lib_sets = []
        for q_, k_, v_, t_, p_ in sets:
            kseq, vseq = (
                a[t_.long()].reshape(B, T, kvh, hd)
                .repeat_interleave(heads // kvh, dim=2).transpose(1, 2)
                for a in (k_, v_))
            qpos = p_.long()[:, None] + torch.arange(S, device="cuda")[None]
            m = kpos[None, None, :] <= qpos[:, :, None]
            if window is not None:
                m &= kpos[None, None, :] > qpos[:, :, None] - window
            lib_sets.append((q_.transpose(1, 2), kseq, vseq, m[:, None]))
        row["library_ms"], row["library_wall_ms"] = measure(
            lambda q, k, v, m: Fn.scaled_dot_product_attention(
                q, k, v, attn_mask=m, scale=kw["scale"]), lib_sets)
        nbytes, ops = pa_work(positions, S, window, es, heads=heads,
                              kvh=kvh, hd=hd, max_len=max_len)
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, dtype)
    print(f"paged_attention {name:14s} {dtype} {heads}/{kvh} heads hd {hd}"
          f" window {window} max_len {max_len} ({route}): "
          f"max_abs_err={err:.3g} atol={atol}"
          + (f" fma_err={row['fma_max_abs_err']:.3g} merge_err="
             f"{row['merge_max_abs_err']:.3g}" if tc else "")
          + (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
             f"library_ms={row['library_ms']:.4f} bound_ms="
             f"{row['bound_ms']:.5f} ({row['bound_by']}) "
             f"wall_ms={row['wall_ms']:.4f}"
             + (f" (kernel {row['kernel_ms']:.4f} + merge "
                f"{row['merge_ms']:.4f})")
             + (f" fma_ms={row['fma_ms']:.4f} graph_ms by kv_splits "
                f"{row['graph_ms_by_splits']}" if tc else
                f" graph_ms={row['graph_ms']:.4f} plan={row['plan']}")
             if timed else "")
          + (f" plan={row['plan']} ctas/SM={row['ctas_per_sm']}"
             if tc else ""), flush=True)
    return row


def gqa_merge_case(q, k, v, tables, pos, kw, plan):
    """The merge kernel against its plain version on the partials the
    tensor-core GQA kernel leaves at these inputs (as planned: kv_splits >
    1 at every path shape); max abs error (bf16 output, f32 plain)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import mla_merge_ref
    B, S, H_, hd = q.shape
    kvh = kw["num_kv_heads"]
    check(plan.kv_splits > 1, "the planned GQA call does not split")
    q2 = pa._q_rows(q, kw["scale"], kvh, q.dtype)
    ws = torch.empty(plan.workspace_floats(), device="cuda")
    out = torch.empty(q2.shape, dtype=torch.bfloat16, device="cuda")
    pa._launch_gqa_split(q2, k, v, tables, pos, plan, out, ws, S=S,
                         window=kw["window"])
    merged = pa.launches_merge.n
    pa._launch_merge(ws, out, plan.units, plan.row_tiles, plan.kv_splits,
                     hd, plan.rows)
    check(pa.launches_merge.n == merged + 1, "the merge did not count")
    ref = mla_merge_ref(ws, batch=B * kvh, row_tiles=plan.row_tiles,
                        kv_splits=plan.kv_splits, latent=hd, rows=plan.rows)
    torch.cuda.synchronize()
    e = float((out.reshape(B * kvh, plan.rows, hd).float() - ref).abs()
              .max())
    check(e <= TOL["bfloat16"][0], f"gqa merge: max err {e}")
    return e


def gqa_issue_order(report):
    """The tensor-core GQA kernel's issue-order record against
    `chunk_issue_schedule`, for the first run of >= 4 live blocks at the
    decode inputs: kv_splits 1 (lane 3's 7 live blocks in one run) and 2
    (its first run, 4 live blocks), G in {None, 1, 2, 4}."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import chunk_issue_schedule
    nb = SLOTS * (MAX_LEN // BS) + 1
    q, k, v, tables, pos = pa_inputs(SLOTS, 1, [5, 17, 40, 100], "bfloat16",
                                     nb=nb)
    n = 0
    for ks in (1, 2):
        for G in (None, 1, 2, 4):
            got, steps, g_used, C, cta = pa.issue_order_gqa(
                q, k, v, tables, pos, num_kv_heads=H, scale=0.125,
                num_bufs=G, kv_splits=ks)
            check(steps == (7 if ks == 1 else 4),
                  f"gqa issue order: {steps} steps recorded")
            check(G is None or g_used == min(G, 8 // ks),
                  f"gqa ring depth {g_used} != {G}")
            check(got == chunk_issue_schedule(steps, g_used, C),
                  f"gqa issue order differs at G={G} kv_splits={ks}")
            n += 1
            print(f"paged_attention_tc issue order kv_splits={ks} "
                  f"G={g_used} (asked {G}) C={C} CTA {cta} steps={steps}: "
                  f"{sum(len(v) for v in got.values())} chunk issues == "
                  "chunk_issue_schedule")
    report["paged_attention_issue_orders"] = n


def check_paged(report):
    """qwen1.5-0.5b's GQA paged attention at its three step shapes: bf16
    (the tensor-core kernel) with and without a 32-token window, f32 (the
    FMA kernel), all timed but f32 prefill and verify; then the
    tensor-core plan's other head dims (128 and 256, fewer KV heads) at
    decode and verify, and its issue order."""
    rows = []
    for name, B, S, positions in PA_CASES:
        for dtype in BOTH:
            rows.append(pa_case(name, B, S, positions, dtype,
                                timed=dtype == "bfloat16"
                                or name == "decode"))
        rows.append(pa_case(name + "+window", B, S, positions, "bfloat16",
                            window=32, timed=True))
    for hd, kvh in ((128, 4), (256, 8)):
        for name, B, S, positions in PA_CASES:
            if name != "prefill":
                for window in (None, 32):
                    rows.append(pa_case(
                        f"{name}{'+window' if window else ''}", B, S,
                        positions, "bfloat16", window=window, hd=hd,
                        kvh=kvh))
    # slice 11's archs at their own heads and windows, bf16 at the three
    # step shapes (timed at decode), f32 at decode
    for arch, (heads, kvh, hd, window, max_len, cases) in NEW_PA.items():
        for name, B, S, positions in cases:
            for dtype in BOTH:
                if dtype == "float32" and name != "decode":
                    continue
                rows.append(pa_case(
                    f"{arch} {name}", B, S, positions, dtype,
                    window=window, hd=hd, kvh=kvh, heads=heads,
                    max_len=max_len, timed=name == "decode"))
    gqa_issue_order(report)
    report["paged_attention"] = {"shapes": rows}
    return rows


# ---------------------------------------------------------------------------
# kernel 2: gpp_matmul_grouped (deepseek-v2-lite-16b routed experts)
# ---------------------------------------------------------------------------

# rows per expert = dispatch groups x capacity (models.moe) at each phase
DS_ROWS = {"decode": 32, "prefill": 128, "verify": 32}
DS_PROJ = {"gate_up": (DS_D, DS_F), "down": (DS_F, DS_D)}


def grouped_inputs(M, K, N, dtype, *, seed=0, int8=False):
    import torch
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(DS_E, M, K, generator=g, device="cuda").to(dt)
    if int8:
        w = torch.randint(-127, 128, (DS_E, K, N), generator=g,
                          device="cuda", dtype=torch.int8)
    else:
        w = (torch.randn(DS_E, K, N, generator=g, device="cuda")
             * 0.02).to(dt)
    return x, w


def grouped_case(M, K, N, dtype, *, G=None, act=None, bias=False,
                 scale=None, seed=0):
    """One gpp_matmul_grouped comparison on the card at deepseek's expert
    count; max abs error (`grouped_check`)."""
    import torch
    x, w = grouped_inputs(M, K, N, dtype, seed=seed, int8=scale is not None)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    sc = None
    if scale is not None:
        shape = {"scalar": (), "expert": (DS_E,), "column": (DS_E, N)}[scale]
        sc = torch.rand(shape, generator=g, device="cuda") * 2e-3
    b = (torch.randn(DS_E, N, generator=g, device="cuda") * 0.1).to(x.dtype) \
        if bias else None
    return grouped_check(x, w, G=G, act=act, b=b, sc=sc,
                         what=f"scale={scale}")


def grouped_check(x, w, *, G=None, act=None, b=None, sc=None, what=""):
    """gpp_matmul_grouped on (E, M, K) x and (E, K, N) W against its plain
    version; max abs error.  bf16 x and W must launch the tensor-core
    kernel, anything else the FMA kernel."""
    import torch
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels.ref import dense_grouped_ref
    E, M, K = x.shape
    N = w.shape[2]
    dtype = str(x.dtype).split(".")[-1]
    route = gm.grouped_route(x.dtype, w.dtype)
    before = (gm.launches_grouped_tc.n, gm.launches_grouped.n)
    y = gm.gpp_matmul_grouped(x, w, bias=b, w_scale=sc, activation=act,
                              num_bufs=G)
    ran = (gm.launches_grouped_tc.n - before[0],
           gm.launches_grouped.n - before[1])
    check(ran == ((1, 0) if route == "tc" else (0, 1)),
          f"gpp_matmul_grouped {dtype} x {w.dtype} W took the wrong kernel")
    ref = dense_grouped_ref(x, w, bias=b, w_scale=sc, activation=act)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(y.float()).all()), "gpp_matmul_grouped "
          "non-finite")
    err = (y.float() - ref.float()).abs()
    atol, rtol = TOL[dtype]
    check(bool((err <= atol + rtol * ref.float().abs()).all()),
          f"gpp_matmul_grouped {E}x{M}x{K}x{N} {dtype} G={G} act={act} "
          f"{what}: max err {float(err.max())}")
    return float(err.max())


def grouped_time(M, K, N, dtype, *, sets=None, E=DS_E):
    """Kernel / plain / torch.bmm times of one (E, M, K) @ (E, K, N) launch
    at the path's shape, and its bound (every expert's W read once).  bf16
    times the tensor-core kernel, f32 the split-K FMA kernel (torch.bmm in
    f32 with TF32 off).  `sets` gives the (x, W) inputs (kimi-k2's 11.3 GB
    expert stacks: one set), else deepseek's are drawn."""
    import torch
    from repro_torch.kernels.gpp_matmul import gpp_matmul_grouped
    from repro_torch.kernels.ref import dense_grouped_ref
    es = 2 if dtype == "bfloat16" else 4
    if sets is None:
        sets = [grouped_inputs(M, K, N, dtype, seed=i)
                for i in range(copies_for(E * K * N * es))]
    name = KERNEL_NAMES["gpp_matmul_grouped_tc" if dtype == "bfloat16"
                        else "gpp_matmul_grouped"]
    ms, wall = measure(lambda x, w: gpp_matmul_grouped(x, w), sets, name)
    # the plain version of kimi's 11.3 GB stacks takes ~50 ms a call: a
    # tenth of the calls
    plain, plain_wall = measure(lambda x, w: dense_grouped_ref(x, w), sets,
                                iters=10 if E > DS_E else 100)
    lib, lib_wall = measure(lambda x, w: torch.bmm(x, w), sets)
    b_ms, by = bound(E * (M * K + K * N + M * N) * es,
                     2.0 * E * M * K * N, dtype)
    return {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
            "bound_by": by, "wall_ms": wall, "plain_wall_ms": plain_wall,
            "library_wall_ms": lib_wall, "kernel": name}


def grouped_issue_order(x, w, G, what, experts=1):
    """Read the first CTA's issue-order record back and compare it with
    `chunk_issue_schedule`; the run must hold more than one work item and
    at least `experts` experts.  Returns (G used, work items in the run)."""
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels.ref import chunk_issue_schedule
    got, steps, g_used, C, items, n_exp = gm.issue_order_grouped(x, w, G)
    check(G is None or g_used == G, f"{what}: ring depth {g_used} != {G}")
    check(items > 1 and n_exp >= experts,
          f"{what}: the first CTA's run holds {items} item(s) of {n_exp} "
          "expert(s)")
    check(got == chunk_issue_schedule(steps, g_used, C),
          f"{what}: issue order differs at G={G}")
    print(f"gpp_matmul_grouped issue order {what} G={g_used} (asked {G}) "
          f"C={C} steps={steps} over {items} work items of {n_exp} "
          f"expert(s): {sum(len(v) for v in got.values())} chunk issues == "
          "chunk_issue_schedule")
    return g_used, items


def check_grouped(report):
    import torch
    from repro_torch.core.schedule import (plan_grouped_tc_sm90,
                                           plan_matmul_fma_sm90)
    from repro_torch.kernels import gpp_matmul as gm
    rows = []
    timed = {}
    for phase, M in DS_ROWS.items():
        for name, (K, N) in DS_PROJ.items():
            for dtype in ("bfloat16", "float32"):
                err = max(grouped_case(M, K, N, dtype, G=G,
                                       act="silu" if name == "gate_up"
                                       else None)
                          for G in (None, 1, 2, 4))
                row = {"phase": phase, "proj": name, "E": DS_E, "M": M,
                       "K": K, "N": N, "dtype": dtype, "max_abs_err": err,
                       "tol": TOL[dtype],
                       "route": "tc" if dtype == "bfloat16" else "fma"}
                key = (M, K, N, dtype)       # verify's shape is decode's
                if key not in timed:
                    timed[key] = grouped_time(M, K, N, dtype)
                row.update(timed[key])
                # the card holds the CTAs an SM the plan assumed
                if dtype == "bfloat16":
                    plan = plan_grouped_tc_sm90(DS_E, M, K, N)
                    row["ctas_per_sm"] = gm.grouped_tc_ctas_per_sm(plan)
                else:
                    plan = plan_matmul_fma_sm90(M, K, N, w_itemsize=4,
                                                E=DS_E)
                    row["ctas_per_sm"] = gm.fma_ctas_per_sm(
                        plan, torch.float32, torch.float32)
                check(row["ctas_per_sm"] == plan.ctas_per_sm,
                      f"gpp_matmul_grouped {dtype} {DS_E}x{M}x{K}x{N}: "
                      f"{row['ctas_per_sm']} CTAs an SM, planned "
                      f"{plan.ctas_per_sm}")
                row["plan"] = {"block_m": plan.block_m,
                               "block_k": plan.block_k,
                               "num_bufs": plan.num_bufs, "grid": plan.grid}
                rows.append(row)
                print(f"gpp_matmul_grouped {phase:7s} {name:7s} "
                      f"{DS_E}x{M}x{K}x{N} {dtype} ({row['route']}): "
                      f"max_abs_err={err:.3g} (atol,rtol)={TOL[dtype]}"
                      f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f}"
                      f" library_ms (torch.bmm)={row['library_ms']:.4f} "
                      f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})"
                      f" wall_ms={row['wall_ms']:.4f} plan={row['plan']} "
                      f"ctas/SM={row['ctas_per_sm']}", flush=True)
    extra = {"tc": [], "fma": []}
    for dtype in ("bfloat16", "float32"):      # int8 W: the FMA route
        for scale in ("scalar", "expert", "column"):
            extra["fma"].append(grouped_case(DS_ROWS["decode"], DS_D, DS_F,
                                             dtype, scale=scale, act="silu"))
    for G in (None, 1, 2, 4):                  # ragged M, K, N
        extra["tc"].append(grouped_case(7, 300, 130, "bfloat16", bias=True,
                                        act="gelu", G=G))
        extra["fma"].append(grouped_case(7, 300, 130, "float32", bias=True,
                                         act="gelu", G=G))
    print("gpp_matmul_grouped int8/bias/ragged cases: "
          + ", ".join(f"{r} {len(v)} ok, max_abs_err={max(v):.3g}"
                      for r, v in extra.items()))
    # the FMA route sums split tiles in segment order: bitwise repeatable,
    # and a row's bits are the same at 8, 32 (decode, verify) and 128
    # (prefill) rows an expert, its k-cuts coming from E, K and N alone
    for name, (K, N) in DS_PROJ.items():
        x, w = grouped_inputs(DS_ROWS["prefill"], K, N, "float32", seed=7)
        y = gm.gpp_matmul_grouped(x, w, activation="silu")
        check(all(torch.equal(gm.gpp_matmul_grouped(x, w, activation="silu"),
                              y) for _ in range(3)),
              f"gpp_matmul_grouped f32 {name}: not bitwise repeatable")
        for M in (8, DS_ROWS["decode"]):
            check(torch.equal(gm.gpp_matmul_grouped(
                x[:, :M].contiguous(), w, activation="silu"), y[:, :M]),
                  f"gpp_matmul_grouped f32 {name}: a row's bits differ at "
                  f"{M} rows an expert")
        print(f"gpp_matmul_grouped f32 {name} {DS_E}x*x{K}x{N}: bitwise "
              "repeatable over 4 runs; a "
              f"row's bits equal at 8 / {DS_ROWS['decode']} / "
              f"{DS_ROWS['prefill']} rows an expert", flush=True)
        del x, w, y
    # the ring runs across work boundaries in the issue order of the
    # generalized ping-pong schedule: the tensor-core route at the path's
    # decode gate/up shape (n-tile boundaries) and at one n-tile an expert
    # (expert boundaries); the FMA route at the decode shape in f32 (tile
    # and k-split boundaries) and at one n-tile an expert (expert ones)
    orders = []
    x, w = grouped_inputs(DS_ROWS["decode"], DS_D, DS_F, "bfloat16")
    for G in (None, 1, 2, 4):
        orders.append(grouped_issue_order(x, w, G, "tc 64x32x2048x1408"))
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(600, 16, 512, generator=g, device="cuda").bfloat16()
    w = (torch.randn(600, 512, 64, generator=g, device="cuda")
         * 0.02).bfloat16()
    for G in (None, 1, 2, 4):
        orders.append(grouped_issue_order(x, w, G, "tc 600x16x512x64",
                                          experts=2))
    x, w = x.float(), w.float()
    for G in (None, 1, 2, 4):
        orders.append(grouped_issue_order(x, w, G, "fma f32 600x16x512x64",
                                          experts=3))
    x, w = grouped_inputs(DS_ROWS["decode"], DS_D, DS_F, "float32")
    for G in (None, 1, 2, 4):
        orders.append(grouped_issue_order(x, w, G, "fma f32 64x32x2048x1408"))
    del x, w
    torch.cuda.empty_cache()
    err = {r: max(v + [row["max_abs_err"] for row in rows
                       if row["route"] == r]) for r, v in extra.items()}
    report["gpp_matmul_grouped"] = {
        "shapes": rows, "extra_cases": sum(map(len, extra.values())),
        "max_abs_err_by_route": err, "issue_orders": len(orders)}
    return rows, err


KIMI_ROWS = {"decode": 32, "prefill": 128, "verify": 32}
KIMI_PROJ = {"gate_up": (7168, KIMI_F), "down": (KIMI_F, 7168)}


def bf16_stack(E, K, N, seed):
    """A (E, K, N) bf16 weight stack drawn on the card 16 experts at a time
    (kimi-k2's 11.3 GB stacks would need 45 GB of f32 drawn at once)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.empty(E, K, N, dtype=torch.bfloat16, device="cuda")
    for e in range(0, E, 16):
        w[e:e + 16] = (torch.randn(min(16, E - e), K, N, generator=g,
                                   device="cuda") * 0.02).bfloat16()
    return w


def check_grouped_kimi(report):
    """The tensor-core gpp_matmul_grouped at kimi-k2's expert stacks (E =
    384, 7168 -> 2048 gate/up and 2048 -> 7168 down, bf16) with 32 rows an
    expert at decode and verify and 128 at prefill (dispatch groups x
    capacity, `models.moe`), at G planned, 1, 2 and 4 against the plain
    version; the planned CTAs an SM held; timed at decode and prefill
    (verify has decode's shape) beside torch.bmm and the bound."""
    import torch
    from repro_torch.core.schedule import plan_grouped_tc_sm90
    from repro_torch.kernels import gpp_matmul as gm
    rows = []
    for name, (K, N) in KIMI_PROJ.items():
        w = bf16_stack(KIMI_E, K, N, seed=21)
        timed = {}
        for phase, M in KIMI_ROWS.items():
            g = torch.Generator(device="cuda").manual_seed(22)
            x = torch.randn(KIMI_E, M, K, generator=g,
                            device="cuda").bfloat16()
            act = "silu" if name == "gate_up" else None
            err = max(grouped_check(x, w, G=G, act=act, what=f"kimi {name}")
                      for G in (None, 1, 2, 4))
            plan = plan_grouped_tc_sm90(KIMI_E, M, K, N)
            row = {"phase": phase, "proj": name, "E": KIMI_E, "M": M,
                   "K": K, "N": N, "dtype": "bfloat16", "max_abs_err": err,
                   "tol": TOL["bfloat16"], "route": "tc",
                   "ctas_per_sm": gm.grouped_tc_ctas_per_sm(plan),
                   "plan": {"block_m": plan.block_m,
                            "block_k": plan.block_k,
                            "num_bufs": plan.num_bufs}}
            check(row["ctas_per_sm"] == plan.ctas_per_sm,
                  f"gpp_matmul_grouped kimi {KIMI_E}x{M}x{K}x{N}: "
                  f"{row['ctas_per_sm']} CTAs an SM, planned "
                  f"{plan.ctas_per_sm}")
            if M not in timed:
                timed[M] = grouped_time(M, K, N, "bfloat16", sets=[(x, w)],
                                        E=KIMI_E)
            row.update(timed[M])
            rows.append(row)
            print(f"gpp_matmul_grouped kimi {phase:7s} {name:7s} "
                  f"{KIMI_E}x{M}x{K}x{N} bfloat16 (tc): max_abs_err="
                  f"{err:.3g} ms={row['ms']:.4f} plain_ms="
                  f"{row['plain_ms']:.4f} library_ms (torch.bmm)="
                  f"{row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']}) wall_ms={row['wall_ms']:.4f} plan="
                  f"{row['plan']} ctas/SM={row['ctas_per_sm']}", flush=True)
            del x
        del w
        torch.cuda.empty_cache()
    report["gpp_matmul_grouped_kimi"] = {"shapes": rows}
    return rows


def check_moe_layer(report, arch):
    """One full-width MoE layer of `arch` in bf16 (random weights from a
    seed), decode inputs (4 tokens) and prefill inputs (32): mode "auto"
    (the routed experts on the tensor-core kernel, the router on the FMA
    one) against mode "ref" (the plain versions), relative error of the
    layer's output; and the experts the router gave a row, so the share
    of the expert weights streamed for experts with none."""
    import dataclasses

    import torch
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import init_from_specs
    cfg = registry.get_config(arch).with_(dtype="bfloat16")
    mc = tf._moe_cfg(cfg)
    d = cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(6)
    torch.cuda.reset_peak_memory_stats()
    params = init_from_specs(moe_mod.moe_specs(mc), gen,
                             torch.device("cuda"))
    out = {}
    for phase, (B, S) in (("decode", (SLOTS, 1)), ("prefill", (1, CHUNK))):
        x = torch.randn(B, S, d, generator=gen, device="cuda").bfloat16()
        tc = gm.launches_grouped_tc.n
        auto = moe_mod.moe_apply(params, mc, x)
        ran = gm.launches_grouped_tc.n - tc
        ref = moe_mod.moe_apply(
            params, dataclasses.replace(mc, dense_kernel="ref"), x)
        torch.cuda.synchronize()
        check(tuple(auto.shape) == (B, S, d)
              and bool(torch.isfinite(auto.float()).all()),
              f"{arch} MoE layer {phase}: shape or non-finite")
        rel = float((auto.float() - ref.float()).norm()
                    / ref.float().norm())
        check(ran == 3, f"{arch} MoE layer {phase}: {ran} tensor-core "
                        "launches")
        check(rel <= 1e-2, f"{arch} MoE layer {phase}: |auto - ref| / |ref| "
                           f"= {rel:.3g} > 1e-2")
        # the experts with a routed row (the kept dispatch entries)
        T = B * S
        G = moe_mod._dispatch_groups(mc, T)
        _, meta = moe_mod._dispatch(params, mc, x.reshape(G, T // G, d),
                                    moe_mod.capacity(mc, T // G))
        sorted_e, _, keep, _, _ = meta
        routed = int(torch.unique(sorted_e[keep]).numel())
        out[phase] = {"tokens": T, "rel_err": rel, "tc_launches": ran,
                      "experts": mc.num_experts, "experts_routed": routed,
                      "expert_bytes_unrouted_share":
                          1.0 - routed / mc.num_experts}
        print(f"{arch} MoE layer {phase} ({T} tokens, bf16): |auto - ref| / "
              f"|ref| = {rel:.3g} (limit 1e-2), {ran} tensor-core launches; "
              f"{routed} of {mc.num_experts} experts routed a row, "
              f"{1.0 - routed / mc.num_experts:.3f} of the expert bytes "
              "streamed for none", flush=True)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    torch.cuda.empty_cache()
    report.setdefault("moe_layer", {})[arch] = out
    return out


# ---------------------------------------------------------------------------
# kernel 3b: MLA paged attention (deepseek-v2-lite-16b latent pools)
# ---------------------------------------------------------------------------

def mla_inputs(B, S, positions, dtype, *, nb, seed=0, bs=BS, share=False,
               max_len=MAX_LEN):
    """Latent pools of `bs`-token blocks, max_len max(max_len, bs); with
    `share`, the lanes' tables name lane 0's blocks (`share_tables`)."""
    import torch
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    mb = max(max_len, bs) // bs
    q = torch.randn(B, S, DS_H, DS_R + DS_RR, generator=g,
                    device="cuda").to(dt)
    ckv = (torch.randn(nb, bs, DS_R, generator=g, device="cuda") * 0.5
           ).to(dt)
    kr = (torch.randn(nb, bs, DS_RR, generator=g, device="cuda") * 0.5
          ).to(dt)
    perm = torch.randperm(nb - 1, generator=g, device="cuda") + 1
    tables = torch.zeros(B, mb, dtype=torch.int32, device="cuda")
    used = 0
    for b, p in enumerate(positions):
        nblk = (p + S - 1) // bs + 1
        tables[b, :nblk] = perm[used:used + nblk].int()
        used += nblk
    if share:
        share_tables(tables, positions, S, bs)
    pos = torch.tensor(positions, dtype=torch.int32, device="cuda")
    return q, ckv, kr, tables, pos


def mla_work(positions, S, es, bs=BS, max_len=MAX_LEN):
    """(bytes, operations) this call's data needs: each visible latent row
    (c_kv + k_rope) read once, q / tables / positions read and the latent
    output written once; per (query row, visible key) 2 * 576 operations
    for q.k and 2 * 512 for p.v, for each of the 16 heads."""
    keys = set()
    pairs = 0
    for b, p in enumerate(positions):
        for s in range(S):
            pairs += p + s + 1
            keys.update((b, t) for t in range(p + s + 1))
    B = len(positions)
    nbytes = (len(keys) * (DS_R + DS_RR) * es
              + B * S * DS_H * (DS_R + DS_RR + DS_R) * es
              + B * (max(max_len, bs) // bs) * 4 + B * 4)
    return nbytes, 2.0 * pairs * DS_H * (DS_R + DS_RR + DS_R)


def mla_case(name, B, S, positions, dtype, *, timed=False, bs=BS,
             share=False):
    """One MLA comparison on the card, at every ring depth and at kv_splits
    planned, 1, 2 and the most (a run a block, or a piece): bf16 at
    `bs`-token blocks of 16-64 must launch the tensor-core kernel, bf16 at
    other block sizes the FMA kernel's bf16 instance, f32 the FMA kernel.
    `timed` adds the kernel's device time (its merge included, and each
    alone), the plain version's, SDPA's on gathered rows, the bound and
    the CUDA-event time of a graph of launches, with the FMA route's plan
    (P, kv_splits, grid)."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.core.schedule import (plan_paged_attn_fma_sm90,
                                           plan_paged_attn_mla_tc_sm90)
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attn_ref
    mb = max(MAX_LEN, bs) // bs
    nb = SLOTS * mb + 1
    q, ckv, kr, tables, pos = mla_inputs(B, S, positions, dtype, nb=nb,
                                         bs=bs, share=share)
    kw = dict(num_kv_heads=1, scale=1.0 / math.sqrt(128 + DS_RR), mla=True)
    ref = paged_attn_ref(q, ckv, kr, tables, pos, **kw)
    route = pa.attention_route(q.dtype, True, bs, DS_R, DS_RR)
    tc = route == "mla_tc"
    counts = (pa.launches_mla_tc, pa.launches_mla, pa.launches_mla_bf16)
    want = (1, 0, 0) if tc else (0, 0, 1) if dtype == "bfloat16" \
        else (0, 1, 0)
    fplan = plan_paged_attn_fma_sm90(
        batch=B, kv_heads=1, rows=DS_H * S, block_size=bs, max_blocks=mb,
        width=DS_R, rope=DS_RR, mla=True, kv_itemsize=q.element_size())
    errs = []
    for G in ((None, 1, 2, 4) if bs == BS else (None, 1, 2)):
        for ks in (None, 1, 2, mb if tc else fplan.pieces):
            before = [c.n for c in counts]
            out = pa.paged_attention(q, ckv, kr, tables, pos, num_bufs=G,
                                     kv_splits=ks, **kw)
            torch.cuda.synchronize()
            ran = tuple(c.n - n for c, n in zip(counts, before))
            check(ran == want, f"mla {name} {dtype} block {bs} took the "
                               f"wrong kernel: {ran}")
            if tc and ks is None and G is None:   # the partials' merge
                merge_err = mla_merge_case(q, ckv, kr, tables, pos, kw)
            check(tuple(out.shape) == (B, S, DS_H, DS_R), f"{name}: shape")
            check(bool(torch.isfinite(out.float()).all()),
                  f"{name}: non-finite")
            errs.append(float((out.float() - ref.float()).abs().max()))
    err = max(errs)
    atol, _ = TOL[dtype]
    check(err <= atol, f"paged_attention mla {name} {dtype} block {bs}: "
                       f"max err {err}")
    row = {"case": name, "B": B, "S": S, "positions": positions,
           "dtype": dtype, "block_size": bs, "route": route,
           "max_abs_err": err, "tol": atol,
           "kernel": (KERNEL_NAMES["paged_attention_mla_tc"],
                      KERNEL_NAMES["paged_attention_merge"]) if tc
           else KERNEL_NAMES["paged_attention_mla"]}
    if not tc:
        row["plan"] = {"piece": fplan.piece, "kv_splits": fplan.kv_splits,
                       "grid": list(fplan.grid)}
    if tc:
        row["merge_max_abs_err"] = merge_err
    if tc:
        plan = plan_paged_attn_mla_tc_sm90(
            batch=B, rows=DS_H * S, block_size=BS, max_blocks=MAX_LEN // BS,
            latent=DS_R, rope=DS_RR)
        row["plan"] = {"kv_splits": plan.kv_splits, "num_bufs":
                       plan.num_bufs, "ctas": plan.ctas,
                       "ctas_per_sm": plan.ctas_per_sm}
        row["ctas_per_sm"] = pa.mla_tc_ctas_per_sm(plan, DS_R, DS_RR)
        check(row["ctas_per_sm"] >= plan.ctas_per_sm,
              f"mla {name}: the card holds {row['ctas_per_sm']} CTAs an SM, "
              f"planned {plan.ctas_per_sm}")
    if timed:
        es = q.element_size()
        n = copies_for(ckv.numel() * es + kr.numel() * es)
        sets = [mla_inputs(B, S, positions, dtype, nb=nb, seed=i, bs=bs)
                for i in range(n)]
        # (the kernel and its merge, summed)
        if not tc:
            fma_times(row, lambda q, c, k, t, p: pa.paged_attention(
                q, c, k, t, p, **kw), sets, row["kernel"], fplan,
                lambda q2, c, k, t, p: pa._launch_fma(
                    q2, c, k, t, p, fplan, S=S, window=None),
                [(pa._q_rows(q_, kw["scale"], 1, q_.dtype), c_, k_, t_, p_)
                 for q_, c_, k_, t_, p_ in sets])
        else:
            row["ms"], row["wall_ms"] = measure(
                lambda q, c, k, t, p: pa.paged_attention(q, c, k, t, p,
                                                         **kw),
                sets, row["kernel"])
            row["kernel_ms"] = device_ms(
                lambda q, c, k, t, p: pa.paged_attention(q, c, k, t, p, **kw),
                sets, KERNEL_NAMES["paged_attention_mla_tc"])
            row["merge_ms"] = device_ms(
                lambda q, c, k, t, p: pa.paged_attention(q, c, k, t, p, **kw),
                sets, KERNEL_NAMES["paged_attention_merge"])
            # the launches alone, on pre-scaled q rows
            row["graph_ms"] = graph_ms(
                lambda q2, c, k, t, p: pa._launch_mla_tc(
                    q2, c, k, t, p, plan, S=S, window=None),
                [(pa._q_rows(q_, kw["scale"], 1, q_.dtype), c_, k_, t_, p_)
                 for q_, c_, k_, t_, p_ in sets])
        row["plain_ms"], row["plain_wall_ms"] = measure(
            lambda q, c, k, t, p: paged_attn_ref(q, c, k, t, p, **kw), sets)
        # yardstick: SDPA over latent rows gathered beforehand, the key
        # concat(c_kv, k_rope) and the value c_kv broadcast over 16 heads
        T = mb * bs
        kpos = torch.arange(T, device="cuda")
        lib_sets = []
        for q_, c_, k_, t_, p_ in sets:
            cseq = c_[t_.long()].reshape(B, 1, T, DS_R)
            kseq = torch.cat([cseq, k_[t_.long()].reshape(B, 1, T, DS_RR)],
                             dim=-1)
            qpos = p_.long()[:, None] + torch.arange(S, device="cuda")[None]
            m = kpos[None, None, :] <= qpos[:, :, None]
            lib_sets.append((q_.transpose(1, 2),
                             kseq.expand(B, DS_H, T, DS_R + DS_RR),
                             cseq.expand(B, DS_H, T, DS_R), m[:, None]))
        row["library_ms"], row["library_wall_ms"] = measure(
            lambda q, k, v, m: Fn.scaled_dot_product_attention(
                q, k, v, attn_mask=m, scale=kw["scale"]), lib_sets)
        nbytes, ops = mla_work(positions, S, es, bs)
        row["bound_ms"], row["bound_by"] = bound(nbytes, ops, dtype)
    print(f"paged_attention mla {name:8s} {dtype} block {bs} ({route}): "
          f"max_abs_err={err:.3g} "
          f"atol={atol}" + (
              f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"library_ms={row['library_ms']:.4f} bound_ms="
              f"{row['bound_ms']:.5f} ({row['bound_by']}) "
              f"wall_ms={row['wall_ms']:.4f}"
              + f" graph_ms={row['graph_ms']:.4f} (kernel "
              f"{row['kernel_ms']:.4f} + merge {row['merge_ms']:.4f})"
              if timed else "")
          + f" plan={row['plan']}"
          + (f" ctas/SM={row['ctas_per_sm']}" if tc else ""), flush=True)
    return row


def mla_merge_case(q, ckv, kr, tables, pos, kw):
    """The merge kernel against its plain version on the partials the
    tensor-core kernel leaves at these inputs (as planned: kv_splits > 1 at
    every path shape); max abs error (bf16 output, f32 plain)."""
    import torch
    from repro_torch.core.schedule import plan_paged_attn_mla_tc_sm90
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import mla_merge_ref
    B, S = q.shape[:2]
    plan = plan_paged_attn_mla_tc_sm90(
        batch=B, rows=DS_H * S, block_size=BS, max_blocks=MAX_LEN // BS,
        latent=DS_R, rope=DS_RR)
    check(plan.kv_splits > 1, "the planned MLA call does not split")
    ws = torch.empty(plan.workspace_floats(DS_R), device="cuda")
    out = torch.empty((B, 1, DS_H * S, DS_R), dtype=torch.bfloat16,
                      device="cuda")
    pa._launch_mla_split(pa._q_rows(q, kw["scale"], 1, q.dtype), ckv, kr,
                         tables, pos, plan, out, ws, S=S, window=None)
    merged = pa.launches_merge.n
    pa._launch_merge(ws, out, B * plan.row_tiles, plan.row_tiles,
                     plan.kv_splits, DS_R, plan.rows)
    check(pa.launches_merge.n == merged + 1, "the merge did not count")
    ref = mla_merge_ref(ws, batch=B, row_tiles=plan.row_tiles,
                        kv_splits=plan.kv_splits, latent=DS_R,
                        rows=DS_H * S)
    torch.cuda.synchronize()
    e = float((out.reshape(B, -1, DS_R).float() - ref).abs().max())
    check(e <= TOL["bfloat16"][0], f"mla merge: max err {e}")
    return e


def mla_issue_order(report):
    """The tensor-core MLA kernel's issue-order record against
    `chunk_issue_schedule`, for the first run of >= 4 live blocks at the
    decode inputs: kv_splits 1 (lane 3's 7 live blocks in one run) and 2
    (its first run, 4 live blocks)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import chunk_issue_schedule
    nb = SLOTS * (MAX_LEN // BS) + 1
    q, ckv, kr, tables, pos = mla_inputs(SLOTS, 1, [5, 17, 40, 100],
                                         "bfloat16", nb=nb)
    n = 0
    for ks in (1, 2):
        for G in (None, 1, 2, 4):
            got, steps, g_used, C, cta = pa.issue_order_mla(
                q, ckv, kr, tables, pos, scale=0.05, num_bufs=G,
                kv_splits=ks)
            check(steps >= 4, f"mla issue order: {steps} steps recorded")
            check(G is None or g_used == G,
                  f"mla ring depth {g_used} != {G}")
            check(got == chunk_issue_schedule(steps, g_used, C),
                  f"mla issue order differs at G={G} kv_splits={ks}")
            n += 1
            print(f"paged_attention_mla_tc issue order kv_splits={ks} "
                  f"G={g_used} (asked {G}) C={C} CTA {cta} steps={steps}: "
                  f"{sum(len(v) for v in got.values())} chunk issues == "
                  "chunk_issue_schedule")
    report["paged_attention_mla_issue_orders"] = n


# (form, kv_splits) -> (steps, CTA) of the first run of >= 4 live pieces
# at the decode positions: MLA's 8-token pieces put lane 2 (position 40: 6
# live pieces) first; GQA's 16-token pieces lane 3 (100: 7, or a run of 4)
FMA_ISSUE = {("mla", 1): (6, 2), ("mla", 2): (6, 4), ("gqa", 1): (7, 48),
             ("gqa", 2): (4, 96)}


def fma_issue_order(report):
    """The FMA kernel's issue-order record against `chunk_issue_schedule`,
    for the first run of >= 4 live pieces at the decode inputs
    (`FMA_ISSUE`): MLA in f32 and bf16 (deepseek's latent pools) and GQA in
    f32 (qwen's K / V), kv_splits 1 and 2, G in {None, 1, 2, 4}."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import chunk_issue_schedule
    nb = SLOTS * (MAX_LEN // BS) + 1
    n = 0
    for form, dtype in (("mla", "float32"), ("mla", "bfloat16"),
                        ("gqa", "float32")):
        if form == "mla":
            q, a, b, tables, pos = mla_inputs(SLOTS, 1, [5, 17, 40, 100],
                                              dtype, nb=nb)
        else:
            q, a, b, tables, pos = pa_inputs(SLOTS, 1, [5, 17, 40, 100],
                                             dtype, nb=nb)
        for ks in (1, 2):
            for G in (None, 1, 2, 4):
                got, steps, g_used, C, cta = pa.issue_order_fma(
                    q, a, b, tables, pos, num_kv_heads=1 if form == "mla"
                    else H, scale=0.05, mla=form == "mla", num_bufs=G,
                    kv_splits=ks)
                check((steps, cta) == FMA_ISSUE[(form, ks)],
                      f"fma {form} issue order: {steps} steps recorded by "
                      f"CTA {cta}")
                check(G is None or g_used == G,
                      f"fma {form} ring depth {g_used} != {G}")
                check(got == chunk_issue_schedule(steps, g_used, C),
                      f"fma {form} {dtype} issue order differs at G={G} "
                      f"kv_splits={ks}")
                n += 1
                print(f"paged_attention fma {form} {dtype} issue order "
                      f"kv_splits={ks} G={g_used} (asked {G}) C={C} CTA "
                      f"{cta} steps={steps}: "
                      f"{sum(len(v) for v in got.values())} chunk issues == "
                      "chunk_issue_schedule")
    report["paged_attention_fma_issue_orders"] = n


def check_mla(report):
    cases = [
        ("decode", SLOTS, 1, [5, 17, 40, 100]),
        ("prefill", 1, CHUNK, [37]),             # unaligned chunk start
        ("verify", SLOTS, DRAFT + 1, [3, 30, 64, 90]),
    ]
    rows = []
    for name, B, S, positions in cases:
        for dtype in ("bfloat16", "float32"):
            rows.append(mla_case(name, B, S, positions, dtype,
                                 timed=dtype == "bfloat16"
                                 or name == "decode"))
    mla_issue_order(report)
    fma_issue_order(report)
    report["paged_attention_mla"] = {"shapes": rows}
    return rows


def check_mla_blocks(report):
    """MLA at the block sizes the tensor-core kernel does not take, on the
    FMA kernel: bf16 (its bf16 instance) at 8-, 128- and 256-token blocks
    and f32 at 128 and 256 (which the whole-block design could not hold),
    at the decode, prefill (a chunk of max(32, block size) tokens, as the
    engine cuts it) and verify shapes, held against the plain version,
    each call counted on its own instance's launches alone; timed at
    decode.  A 256-token block gets max_len 256 (`mla_inputs`)."""
    rows = []
    for dtype, sizes in (("bfloat16", (8, 128, 256)),
                         ("float32", (128, 256))):
        for bs in sizes:
            chunk = max(CHUNK, bs)
            for name, B, S, positions in (
                    ("decode", SLOTS, 1, [5, 17, 40, 100]),
                    ("prefill", 1, chunk, [37] if 37 + chunk <= MAX_LEN
                     else [0]),
                    ("verify", SLOTS, DRAFT + 1, [3, 30, 64, 90])):
                rows.append(mla_case(name, B, S, positions, dtype,
                                     timed=name == "decode", bs=bs))
    report["paged_attention_mla_blocks"] = {"shapes": rows}
    return rows


def mla_split_cost(report):
    """What the fixed split of the tensor-core MLA kernel costs where a
    lane's table is wider than its 8 runs: deepseek's bf16 decode, prefill
    and verify at max_len 256 (MB = 16, the prefix phase's), the planned
    runs (`tc_kv_splits`, min(MB, 8)) against the split planned before it
    from the CTAs a step wants, min(MB, ceil(2 x 132 / units)) with units
    = lanes x 16-row tiles (16 / 9 / 14 runs).  Each held against the
    plain version; device time of the kernel and its merge (profiler),
    old / new / new / old, the mean of each pair, beside the bound."""
    import torch
    from repro_torch.core.schedule import (H100_SMS,
                                           plan_paged_attn_mla_tc_sm90)
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import paged_attn_ref
    max_len = 256
    mb = max_len // BS
    kw = dict(num_kv_heads=1, scale=1.0 / math.sqrt(128 + DS_RR), mla=True)
    names = (KERNEL_NAMES["paged_attention_mla_tc"],
             KERNEL_NAMES["paged_attention_merge"])
    rows = []
    for name, B, S, positions in (("decode", SLOTS, 1, [5, 100, 180, 240]),
                                  ("prefill", 1, CHUNK, [80]),
                                  ("verify", SLOTS, DRAFT + 1,
                                   [3, 90, 170, 250])):
        units = B * -(-DS_H * S // 16)
        splits = {"old": min(mb, -(-2 * H100_SMS // units)),
                  "new": plan_paged_attn_mla_tc_sm90(
                      batch=B, rows=DS_H * S, block_size=BS, max_blocks=mb,
                      latent=DS_R, rope=DS_RR).kv_splits}
        nb = SLOTS * mb + 1
        es = 2
        n = copies_for(nb * BS * (DS_R + DS_RR) * es)
        sets = [mla_inputs(B, S, positions, "bfloat16", nb=nb, seed=i,
                           max_len=max_len) for i in range(n)]
        ref = paged_attn_ref(*sets[0], **kw).float()
        err, ms = {}, {"old": [], "new": []}
        for tag, ks in splits.items():
            out = pa.paged_attention(*sets[0], kv_splits=ks, **kw)
            err[tag] = float((out.float() - ref).abs().max())
            check(err[tag] <= TOL["bfloat16"][0],
                  f"mla {name} at MB {mb}, {ks} runs: max err {err[tag]}")
        for tag in ("old", "new", "new", "old"):
            ms[tag].append(device_ms(
                lambda q, c, k, t, p, ks=splits[tag]: pa.paged_attention(
                    q, c, k, t, p, kv_splits=ks, **kw), sets, names))
        nbytes, ops = mla_work(positions, S, es, max_len=max_len)
        b_ms, b_by = bound(nbytes, ops, "bfloat16")
        row = {"case": name, "B": B, "S": S, "positions": positions,
               "max_blocks": mb, "kv_splits": splits, "max_abs_err": err,
               "ms": {k: sum(v) / len(v) for k, v in ms.items()},
               "readings": ms, "bound_ms": b_ms, "bound_by": b_by}
        rows.append(row)
        print(f"paged_attention_mla_tc {name} bf16 at MB {mb}: runs "
              f"{splits['old']} (the split before) ms={row['ms']['old']:.4f}"
              f" / {splits['new']} (planned) ms={row['ms']['new']:.4f} "
              f"(kernel + merge, readings {ms}) bound_ms={b_ms:.5f} ({b_by})"
              f" max_abs_err={err}", flush=True)
    report["mla_split_cost"] = rows
    return rows


def mla_merge_time(row, dtype="bfloat16"):
    """The merge kernel alone at the MLA decode shape (its inputs, the
    partials, are L2-hot on the path: the split kernel has just written
    them), beside its plain version and its bound (the live partials' acc
    and every (m, l) read once, the output written once): the bf16
    instance at the tensor-core kernel's plan, the f32 one at the FMA
    kernel's.  No one PyTorch call merges split-softmax partials:
    library_ms null."""
    import torch
    from repro_torch.core.schedule import (plan_paged_attn_fma_sm90,
                                           plan_paged_attn_mla_tc_sm90)
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels.ref import mla_merge_ref
    B, S, positions = row["B"], row["S"], row["positions"]
    dt = getattr(torch, dtype)
    if dtype == "bfloat16":
        plan = plan_paged_attn_mla_tc_sm90(
            batch=B, rows=DS_H * S, block_size=BS, max_blocks=MAX_LEN // BS,
            latent=DS_R, rope=DS_RR)
        unit, floats = BS, plan.workspace_floats(DS_R)
    else:
        plan = plan_paged_attn_fma_sm90(
            batch=B, kv_heads=1, rows=DS_H * S, block_size=BS,
            max_blocks=MAX_LEN // BS, width=DS_R, rope=DS_RR, mla=True,
            kv_itemsize=4)
        unit, floats = plan.piece, plan.workspace_floats()
    g = torch.Generator(device="cuda").manual_seed(7)
    ws = torch.randn(floats, generator=g, device="cuda")
    ml = ws[plan.ctas * 16 * DS_R:].view(B, plan.row_tiles,
                                         plan.kv_splits, 16, 2)
    ml[..., 1].abs_().add_(1.0)            # l > 0
    live_runs = 0
    for b, p in enumerate(positions):      # empty runs: m = -inf, l = 0
        for s_ in range(plan.kv_splits):
            if not any(j * unit <= p + S - 1 for j in plan.run(s_)):
                ml[b, :, s_, :, 0] = float("-inf")
                ml[b, :, s_, :, 1] = 0.0
            else:
                live_runs += plan.row_tiles
    out = torch.empty((B, 1, DS_H * S, DS_R), dtype=dt, device="cuda")
    kw = dict(batch=B, row_tiles=plan.row_tiles, kv_splits=plan.kv_splits,
              latent=DS_R, rows=DS_H * S, dtype=dt)
    ms, wall = measure(lambda w: pa._launch_merge(
        w, out, B * plan.row_tiles, plan.row_tiles, plan.kv_splits, DS_R,
        plan.rows), [(ws,)], KERNEL_NAMES["paged_attention_merge"])
    plain, plain_wall = measure(lambda w: mla_merge_ref(w, **kw), [(ws,)])
    nbytes = (live_runs * 16 * DS_R * 4 + plan.ctas * 16 * 8
              + B * DS_H * S * DS_R * out.element_size())
    b_ms, by = bound(nbytes, 3.0 * live_runs * 16 * DS_R, "float32")
    return {"ms": ms, "wall_ms": wall, "plain_ms": plain,
            "plain_wall_ms": plain_wall, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None, "kv_splits": plan.kv_splits}


# ---------------------------------------------------------------------------
# RMSNorm (a kernel of the port alone: the reference leaves it to XLA)
# ---------------------------------------------------------------------------

# kv_norm, qwen, a q_norm, deepseek, then slice 11's d_models
# ---------------------------------------------------------------------------
# slice 12: attention where the prefix cache starts a chunk and shares blocks
# ---------------------------------------------------------------------------

# a prefix hit of 1, 3 or 5 blocks starts the 32-token chunk at these
# positions: block-aligned, not chunk-aligned
PREFIX_STARTS = (16, 48, 80)
# the tensor-core GQA shapes (label, heads, kv heads, head_dim, windows):
# qwen1.5, qwen2, gemma3 (its 1024-token window, and a 32-token one that
# binds inside the chunk)
PREFIX_GQA = (("qwen1.5 hd 64", H, H, HD, (None, 32)),
              ("qwen2 hd 128", 28, 4, 128, (None, 32)),
              ("gemma3 hd 256", 16, 8, 256, (None, 1024, 32)))


def check_prefix_starts(report):
    """Each attention kernel against its plain version where the prefix
    cache puts it: a 32-token prefill chunk (B = 1) starting at 16, 48 and
    80 (a hit of 1, 3 or 5 blocks), through the tensor-core GQA kernel at
    head_dim 64 / 128 / 256 with and without a window, the tensor-core MLA
    kernel, the FMA kernel's bf16 instance at head_dim 80 (danube), and
    the FMA GQA and MLA kernels in f32; and decode with lanes whose tables
    name lane 0's blocks (`share_tables`) on every route.  Each case at
    every ring depth and split of `pa_case` / `mla_case`, within their
    tolerances."""
    rows = []
    for start in PREFIX_STARTS:
        at = [start]
        for label, heads, kvh, hd, windows in PREFIX_GQA:
            for window in windows:
                rows.append(pa_case(f"prefix@{start} {label}", 1, CHUNK, at,
                                    "bfloat16", window=window, hd=hd,
                                    kvh=kvh, heads=heads))
        rows.append(pa_case(f"prefix@{start} danube hd 80", 1, CHUNK, at,
                            "bfloat16", window=32, hd=80, kvh=8, heads=32))
        for window in (None, 32):
            rows.append(pa_case(f"prefix@{start} f32", 1, CHUNK, at,
                                "float32", window=window))
        for dtype in BOTH:
            rows.append(mla_case(f"prefix@{start}", 1, CHUNK, at, dtype))
    shared = [70, 75, 66, 90]         # 4-5 blocks, the first 4 lane 0's
    for dtype in BOTH:
        rows.append(pa_case("shared decode", SLOTS, 1, shared, dtype,
                            share=True))
        rows.append(pa_case("shared verify", SLOTS, DRAFT + 1, shared,
                            dtype, window=32, share=True))
        rows.append(mla_case("shared decode", SLOTS, 1, shared, dtype,
                             share=True))
    rows.append(pa_case("shared decode qwen2 hd 128", SLOTS, 1, shared,
                        "bfloat16", hd=128, kvh=4, heads=28, share=True))
    report["prefix_attention"] = [
        {k: r[k] for k in ("case", "dtype", "route", "max_abs_err", "tol")}
        for r in rows]
    print(f"attention at prefix-hit starts {PREFIX_STARTS} and shared "
          f"blocks: {len(rows)} cases, largest error "
          f"{max(r['max_abs_err'] for r in rows):.3g}", flush=True)
    return rows


RMS_WIDTHS = (DS_R, D, 1536, DS_D, *(w[0] for w in NEW_ARCHS.values()))
RMS_ROWS = (1, 4, 5, 16, 20, 32)     # rows a step (or the draft) brings
RMS_EPS = 1e-6


def rms_err(y, ref, dtype) -> "tuple[float, bool]":
    """(max abs error, within tolerance): f32 1e-5 + 1e-5 x |plain| (the
    sum's order and rsqrtf's rounding); bf16 one bf16 step of the plain
    value (2^(floor(log2 |plain|) - 7))."""
    import torch
    d = (y.float() - ref.float()).abs()
    r = ref.float().abs()
    if dtype == "float32":
        tol = 1e-5 + 1e-5 * r
    else:
        tol = torch.exp2(torch.floor(torch.log2(r.clamp(min=2.0 ** -126)))
                         - 7)
    return float(d.max()), bool((d <= tol).all())


def check_rmsnorm(report):
    """The RMSNorm kernel against its plain version at the paths' widths,
    1-32 rows, f32 and bf16, and its row invariance: a row's output bits
    are the same at 1, 5 and 32 rows, at any place in the batch, laid out
    as decode (4 lanes x 1) or verify (4 lanes x 5) steps, and as a strided
    slice of a wider row (MLA's c_kv).  Timed at both paths' decode shape
    (4 rows, bf16)."""
    import torch
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.ref import rmsnorm_ref
    rows = []
    for width in RMS_WIDTHS:
        for dtype in BOTH:
            dt = getattr(torch, dtype)
            g = torch.Generator(device="cuda").manual_seed(11)
            wide = (torch.randn(32, width + 64, generator=g, device="cuda")
                    * 2).to(dt)
            x = wide[:, :width]                # strided rows
            xc = x.contiguous()
            scale = (1 + 0.1 * torch.randn(width, generator=g,
                                           device="cuda")).to(dt)
            before = rn.launches_rmsnorm.n
            err, ok = 0.0, True
            for n in RMS_ROWS:
                e, o = rms_err(rn.rmsnorm(xc[:n], scale, RMS_EPS),
                               rmsnorm_ref(xc[:n], scale, RMS_EPS), dtype)
                err, ok = max(err, e), ok and o
            check(ok, f"rmsnorm width {width} {dtype}: max err {err}")
            full = rn.rmsnorm(xc, scale, RMS_EPS)
            perm = torch.randperm(32, generator=g, device="cuda")
            lanes = xc[:20].reshape(4, 5, width)
            same = {
                "strided": torch.equal(rn.rmsnorm(x, scale, RMS_EPS), full),
                "permuted": torch.equal(rn.rmsnorm(xc[perm], scale,
                                                   RMS_EPS), full[perm]),
                "alone": all(torch.equal(
                    rn.rmsnorm(xc[i:i + 1], scale, RMS_EPS), full[i:i + 1])
                    for i in (0, 7, 31)),
                "five": torch.equal(rn.rmsnorm(xc[:5], scale, RMS_EPS),
                                    full[:5]),
                "decode_verify": torch.equal(
                    rn.rmsnorm(lanes[:, :1].contiguous(), scale,
                               RMS_EPS)[:, 0],
                    rn.rmsnorm(lanes, scale, RMS_EPS)[:, 0])}
            torch.cuda.synchronize()
            check(all(same.values()), f"rmsnorm width {width} {dtype}: a "
                                      f"row's bits depend on the batch "
                                      f"{same}")
            ran = rn.launches_rmsnorm.n - before
            check(ran == len(RMS_ROWS) + 9, f"rmsnorm: {ran} launches")
            row = {"width": width, "dtype": dtype, "rows": list(RMS_ROWS),
                   "max_abs_err": err,
                   "tol": "f32 1e-5 + 1e-5 x |plain|; bf16 one bf16 step",
                   "row_invariant": same}
            if dtype == "bfloat16" and width in (D, DS_D):
                row.update(rms_time(SLOTS, width))
            rows.append(row)
            print(f"rmsnorm width {width} {dtype}: max_abs_err={err:.3g}, "
                  f"a row's bits the same "
                  f"at 1 / 5 / 32 rows, permuted, strided, decode vs "
                  f"verify: {all(same.values())}"
                  + (f" ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
                     f"library_ms={row['library_ms']} bound_ms="
                     f"{row['bound_ms']:.5f} ({row['bound_by']}) wall_ms="
                     f"{row['wall_ms']:.4f}" if "ms" in row else ""),
                  flush=True)
    report["rmsnorm"] = {"shapes": rows}
    return rows


def rms_time(M, d):
    """Kernel / plain / F.rms_norm times of M rows of width d (bf16), and
    the bound (each row read once and written once, the scale read
    once)."""
    import torch
    import torch.nn.functional as Fn
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.ref import rmsnorm_ref
    g = torch.Generator(device="cuda").manual_seed(3)
    sets = [((torch.randn(M, d, generator=g, device="cuda")).bfloat16(),
             (1 + 0.1 * torch.randn(d, generator=g, device="cuda"))
             .bfloat16()) for _ in range(64)]
    out = {}
    out["ms"], out["wall_ms"] = measure(
        lambda x, s: rn.rmsnorm(x, s, RMS_EPS), sets,
        KERNEL_NAMES["rmsnorm"])
    out["plain_ms"], out["plain_wall_ms"] = measure(
        lambda x, s: rmsnorm_ref(x, s, RMS_EPS), sets)
    lib = getattr(Fn, "rms_norm", None)
    out["library_ms"] = None if lib is None else measure(
        lambda x, s: lib(x, (d,), s, RMS_EPS), sets)[0]
    out["bound_ms"], out["bound_by"] = bound((2 * M * d + d) * 2,
                                             4.0 * M * d, "float32")
    return out


# ---------------------------------------------------------------------------
# the paper's workload: consecutive GeMMs with streamed weights
# ---------------------------------------------------------------------------

SEQ_K, SEQ_R, SEQ_M = 4096, 8, (8, 128)  # 8 rounds of 4096 x 4096 (256 MB)
SIM_MACROS = 32            # the reference ledger's simulated macros
GATE_REPEATS = 5           # readings a ring depth for the planned-G gate


def ring_medians(call_for, Gs, name) -> dict:
    """{G: median device ms} of `call_for(G)()` over GATE_REPEATS
    readings of 20 calls each, the ring depths taken in turns (forward,
    then backward), so a drift in the card's clock falls on all alike."""
    import statistics
    times = {G: [] for G in Gs}
    for rep in range(GATE_REPEATS):
        for G in (Gs if rep % 2 == 0 else Gs[::-1]):
            times[G].append(device_ms(call_for(G), [()], name, iters=20))
    return {G: statistics.median(v) for G, v in times.items()}


def check_serving_plans() -> int:
    """No serving shape's tensor-core plan moved when the planner began to
    weigh waves: at every bf16 projection of the six archs at 4, 16, 20
    and 32 rows, the plan runs in one wave and its ring is the deepest the
    clamps and the shared memory allow (what it was before)."""
    from repro_torch.core import schedule as sc
    n = 0
    for projs in GPP_SHAPES.values():
        for K, N, dtypes in projs.values():
            if "bfloat16" not in dtypes:
                continue
            for M in (4, 16, 20, 32):
                p = sc.plan_matmul_tc_sm90(M, K, N)
                deepest = min(sc._ring_depth(
                    p.block_k * p.block_n * 2,
                    2.0 * p.block_m * p.block_k * p.block_n,
                    sc.H100_BF16_FLOPS), -(-p.num_k // p.cluster),
                    sc.GPP_MM_TC_MAX_RING)
                while deepest > 1 and sc.matmul_tc_smem_bytes(
                        p.block_m, p.block_k, p.block_n,
                        deepest) > sc.SMEM_BUDGET_BYTES:
                    deepest -= 1
                check(sc.tc_waves(p.tiles, p.cluster, p.smem_bytes) == 1
                      and p.num_bufs == deepest,
                      f"the serving plan at {M}x{K}x{N} moved: G = "
                      f"{p.num_bufs} (deepest {deepest})")
                n += 1
    print(f"tensor-core plans: {n} serving shapes in one wave at their "
          "deepest ring (unchanged)", flush=True)
    return n


def check_gemm_sequence(report):
    """`kernels.ops.streamed_gemm_sequence` in bf16: x (M, 4096) against 8
    rounds of (4096 x 4096) weights, 256 MB, more than the L2, the rounds
    folded into N (one tensor-core gpp_matmul launch, 256 tiles), at M = 8
    and 128, at G = 1 (in-situ), 2 (naive ping-pong), 3 and 4 (GPP) and
    the planned G (`gpp_matmul`'s own, num_bufs None), each held against
    its plain version.  Prints the
    kernel's device time on the folded W and the whole call's (the fold
    copies W), and the achieved share of 3.35e12 B/s.  A tile's measured
    transfer (a device copy of W) and compute (the kernel's FLOP rate on
    an L2-resident 1024 x 16384 slice, 128 CTAs) go into a `TimingCache`
    as compiled samples; beside
    them, the copied simulator's bus-busy share and latency for insitu /
    naive_pp / gpp at that measured ratio (t_pim / t_rw mapped onto
    PimConfig.n_in as the reference's ledger does), and the ring depth the
    measured rates plan against the data sheet's.  Claims nothing."""
    import torch
    from repro_torch.core.analytical import PimConfig
    from repro_torch.core.schedule import TimingCache, plan_matmul_tc_sm90
    from repro_torch.core.simulator import simulate
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import dense_ref
    K = N = SEQ_K
    R = SEQ_R
    ws = bf16_stack(R, K, N, seed=31)
    w_flat = ops.fold_rounds(ws)
    wbytes = R * K * N * 2
    dst = torch.empty_like(w_flat)
    copy_ms = time_ms(lambda: dst.copy_(w_flat), [()], iters=20)
    del dst
    tcache = TimingCache()
    rows, sims = [], {}
    name = KERNEL_NAMES["gpp_matmul_tc"]
    for M in SEQ_M:
        g = torch.Generator(device="cuda").manual_seed(32)
        x = torch.randn(M, K, generator=g, device="cuda").bfloat16()
        want = dense_ref(x, w_flat).reshape(M, R, N).permute(1, 0, 2)
        analytic = ops.plan_ring_depth(M, K, 256)
        planned = plan_matmul_tc_sm90(M, K, R * N).num_bufs
        rows_m = []
        for G in dict.fromkeys((1, 2, 3, 4, planned)):
            pin = None if G == planned else G   # the planned G: unpinned
            before = gm.launches_tc.n
            y = ops.streamed_gemm_sequence(x, ws, num_bufs=pin)
            check(gm.launches_tc.n == before + 1,
                  "the GeMM sequence is not one tensor-core launch")
            err = (y.float() - want.float()).abs()
            atol, rtol = TOL["bfloat16"]
            check(tuple(y.shape) == (R, M, N)
                  and bool((err <= atol + rtol * want.float().abs()).all()),
                  f"GeMM sequence M={M} G={G}: max err {float(err.max())}")
            ms = measure(lambda: gm.gpp_matmul(x, w_flat, num_bufs=pin),
                         [()], name)[0]
            call_ms, call_wall = measure(
                lambda: ops.streamed_gemm_sequence(x, ws, num_bufs=pin),
                [()])
            nbytes = wbytes + M * K * 2 + M * R * N * 2
            plan = plan_matmul_tc_sm90(M, K, R * N, num_bufs=G)
            row = {"M": M, "G": G, "planned": G == planned,
                   "max_abs_err": float(err.max()), "ms": ms,
                   "call_ms": call_ms, "call_wall_ms": call_wall,
                   "bytes": nbytes,
                   "achieved_share": nbytes / (ms * 1e-3)
                   / H100_HBM_BYTES_PER_S,
                   "plan": {"block_m": plan.block_m,
                            "block_n": plan.block_n,
                            "block_k": plan.block_k,
                            "cluster": plan.cluster, "ctas": plan.ctas}}
            rows_m.append(row)
            print(f"GeMM sequence M={M} x {R} rounds of {K}x{N} bf16 G={G}"
                  f"{' (planned)' if G == planned else ''}: kernel ms="
                  f"{ms:.4f} achieved {row['achieved_share']:.3f} of "
                  f"3.35e12 B/s; call (with the fold) ms={call_ms:.4f}; "
                  f"max_abs_err={row['max_abs_err']:.3g} plan="
                  f"{row['plan']}", flush=True)
        # the planner weighs waves against ring depth: the planned G runs
        # within 5% of the fastest of G = 1..4.  Rings that tie (G = 2 and
        # 3 at 8 rows) part by ~5% from one reading to the next, so the
        # gate takes each G's median over GATE_REPEATS readings in turns
        gate = ring_medians(
            lambda G: (lambda: gm.gpp_matmul(
                x, w_flat, num_bufs=None if G == planned else G)),
            (1, 2, 3, 4), name)
        fastest = min(gate, key=gate.get)
        check(gate[planned] <= 1.05 * gate[fastest],
              f"GeMM sequence M={M}: the planned G = {planned} runs "
              f"{gate[planned]:.4f} ms (median), G = {fastest} "
              f"{gate[fastest]:.4f}")
        print(f"GeMM sequence M={M}: medians of {GATE_REPEATS} readings in "
              f"turns by G {({G: round(v, 5) for G, v in gate.items()})}; "
              f"planned G = {planned} against the fastest, G = {fastest}: "
              f"{gate[planned] / gate[fastest]:.4f} (gate 1.05)", flush=True)
        # one (block_k, block_n) tile of the planned launch, measured: its
        # transfer at the copy's rate, its compute at the kernel's FLOP
        # rate where W is L2-resident (a 32 MB slice, the same buffer each
        # call, 128 CTAs), so its bytes cost next to nothing
        plan = plan_matmul_tc_sm90(M, K, R * N, num_bufs=planned)
        tile_bytes = plan.block_k * plan.block_n * 2
        tile_flops = 2.0 * M * plan.block_k * plan.block_n
        hot_k, hot_n = 1024, 16384
        w_hot = w_flat[:hot_k, :hot_n].contiguous()
        x_hot = x[:, :hot_k].contiguous()
        hot_ms = device_ms(lambda: gm.gpp_matmul(x_hot, w_hot), [()], name)
        t_dma = copy_ms * 1e-3 / 2 * tile_bytes / wbytes
        t_cmp = hot_ms * 1e-3 * tile_flops / (2.0 * M * hot_k * hot_n)
        del w_hot, x_hot
        tcache.record(block_bytes=tile_bytes, compute_flops=tile_flops,
                      t_dma=t_dma, t_compute=t_cmp, measured_on="compiled")
        ratio = t_cmp / t_dma
        cfg = PimConfig()
        cfg = cfg.with_(n_in=max(1.0, ratio * cfg.size_ou / cfg.s))
        res = {st: simulate(st, cfg, SIM_MACROS, R)
               for st in ("insitu", "naive_pp", "gpp")}
        sims[M] = {
            "t_dma_s": t_dma, "t_compute_s": t_cmp, "ratio_pim_rw": ratio,
            "n_in": cfg.n_in, "l2_hot_ms": hot_ms,
            **{st: {"bus_busy_share": r.bw_busy_cycles / r.total_cycles,
                    "cycles": r.total_cycles,
                    "latency_vs_insitu": r.total_cycles
                    / res["insitu"].total_cycles}
               for st, r in res.items()},
            "measured_vs_g1": {str(r["G"]): r["ms"] / rows_m[0]["ms"]
                               for r in rows_m},
            "gate_median_ms": gate,
            "planned_vs_fastest": gate[planned] / gate[fastest],
            "ring_analytic": analytic, "ring_planned": planned}
        print(f"GeMM sequence M={M}: tile {plan.block_k}x{plan.block_n} "
              f"t_dma={t_dma * 1e6:.4f} us t_compute={t_cmp * 1e6:.4f} us "
              f"(t_pim/t_rw {ratio:.4f} -> n_in {cfg.n_in:.3g}); simulator "
              + ", ".join(f"{st}: bus busy {v['bus_busy_share']:.3f}, "
                          f"latency x{v['latency_vs_insitu']:.3f}"
                          for st, v in sims[M].items() if st in res)
              + f"; measured ms / G=1: {sims[M]['measured_vs_g1']}",
              flush=True)
        rows += rows_m
        del x, y, want
    fps, bps = tcache.effective_rates()
    rings = {M: {"analytic": ops.plan_ring_depth(M, K, 256),
                 "measured": ops.plan_ring_depth(M, K, 256, timing=tcache)}
             for M in SEQ_M}
    print(f"TimingCache (compiled): effective_rates {fps:.4g} FLOP/s, "
          f"{bps:.4g} B/s; ring depth analytic vs measured {rings}",
          flush=True)
    del ws, w_flat
    torch.cuda.empty_cache()
    report["serving_plans_unchanged"] = check_serving_plans()
    report["gemm_sequence"] = {
        "rows": rows, "simulator": sims, "copy_ms": copy_ms,
        "timing_samples": tcache.to_json(),
        "effective_rates": {"flops_per_s": fps, "bytes_per_s": bps},
        "ring_depth": rings}
    return rows


# ---------------------------------------------------------------------------
# the main paths: full-width models through the serving engine
# ---------------------------------------------------------------------------

# kernel counter -> profiler kernel name (the FMA kernels' bf16 instances
# share their f32 names and are told apart by their launch counters)
KERNEL_NAMES = {"gpp_matmul": "gpp_matmul_kernel",
                "gpp_matmul_tc": "gpp_matmul_tc_kernel",
                "gpp_matmul_grouped": "gpp_matmul_grouped_kernel",
                "gpp_matmul_grouped_tc": "gpp_matmul_grouped_tc_kernel",
                "paged_attention": "paged_attention_kernel",
                "paged_attention_tc": "paged_attention_tc_kernel",
                "paged_attention_mla": "paged_attention_mla_kernel",
                "paged_attention_mla_tc": "paged_attention_mla_tc_kernel",
                "paged_attention_merge": "paged_attention_merge_kernel",
                "rmsnorm": "rmsnorm_kernel"}


def counters():
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import rmsnorm as rn
    return {"gpp_matmul": gm.launches, "gpp_matmul_tc": gm.launches_tc,
            "gpp_matmul_grouped": gm.launches_grouped,
            "gpp_matmul_grouped_tc": gm.launches_grouped_tc,
            "paged_attention": pa.launches,
            "paged_attention_bf16": pa.launches_bf16,
            "paged_attention_tc": pa.launches_tc,
            "paged_attention_mla": pa.launches_mla,
            "paged_attention_mla_bf16": pa.launches_mla_bf16,
            "paged_attention_mla_tc": pa.launches_mla_tc,
            "paged_attention_merge": pa.launches_merge,
            "rmsnorm": rn.launches_rmsnorm}


# prompt seeds of the gated bf16 spec-on == spec-off comparison, fixed
# before any run
SPEC_SEEDS = (0, 1, 2)


def random_prompts(vocab: int, requests: int = 4, seed: int = 0):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=rng.integers(4, 13)).tolist()
            for _ in range(requests)]


def repeated_prompts(vocab: int, requests: int = 4, seed: int = 0):
    """Prompts of one token repeated 20-40 times.  On random weights the
    greedy continuation of qwen2-7b and kimi-k2 depends on the whole
    context (after a prompt that holds its own continuation it continues
    elsewhere, and no token of it repeats in 16), so the n-gram drafter
    finds nothing to propose; after one token repeated, the continuation
    repeats too, and speculation runs verify steps."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [[int(rng.integers(0, vocab))] * int(rng.integers(20, 41))
            for _ in range(requests)]


def serve(cfg, params, prompts, *, speculation: bool, mode: str,
          profile=False, max_new: int = 16, block_size: int = BS,
          max_len: int = MAX_LEN, on_step=None, keep_logits=False,
          engine_kw=None, draft_model=None, keep_engine=False,
          cpu_profile=False):
    """Serve `prompts` through the paged engine; `on_step(engine)` (if
    given) is called after every step.  With `keep_logits`, info["logits"]
    holds each request's (tokens, vocab) f32 rows, one an emitted token,
    the row it was sampled from.  `engine_kw` adds ServeConfig fields,
    `draft_model` is the engine's; with `keep_engine`, info["engine"] is
    the engine; with `cpu_profile` the profiler also records the host's
    CUDA runtime calls (info["host_launch"])."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import ServeConfig, make_engine

    engine = make_engine(cfg, params, ServeConfig(
        slots=SLOTS, max_len=max_len, block_size=block_size,
        prefill_chunk=max(CHUNK, block_size),   # a whole number of blocks
        speculation=speculation, draft_len=DRAFT, dense_kernel=mode,
        paged_attn_kernel=mode, **(engine_kw or {})),
        draft_model=draft_model)
    rows = {}
    if keep_logits:
        sample = engine._sample

        def keep(logits_row, req):
            rows.setdefault(req.rid, []).append(
                np.array(logits_row, dtype=np.float32))
            return sample(logits_row, req)
        engine._sample = keep
    torch.cuda.synchronize()
    if profile:
        from torch.profiler import ProfilerActivity
        prof = torch.profiler.profile(activities=[ProfilerActivity.CUDA] + (
            [ProfilerActivity.CPU] if cpu_profile else []))
        prof.start()
    for c in counters().values():
        c.n = 0
    t0 = time.perf_counter()
    rids = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    if on_step is None:
        engine.run()
    else:
        while engine.pending:
            engine.step()
            on_step(engine)
    results = {r: engine.result(r) for r in rids}
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {k: c.n for k, c in counters().items()}
    if profile:
        prof.stop()
        busy = dict.fromkeys([*KERNEL_NAMES, "other"], 0.0)
        host = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = next((k for k, v in KERNEL_NAMES.items()
                            if v in e.name), "other")
                busy[key] += e.time_range.elapsed_us() / 1e6
            elif e.name.startswith(("cudaLaunch", "cudaMemcpy",
                                    "cudaStreamSynchronize")):
                n, us = host.get(e.name, (0, 0.0))
                host[e.name] = (n + 1, us + e.time_range.elapsed_us())
    streams = [results[r] for r in rids]
    ntok = sum(len(s) for s in streams)
    # step-function calls: each runs one logits head
    calls = sum((m["prefill_tokens"] > 0) + (m["decode_tokens"] > 0)
                + (m["verify_tokens"] > 0) for m in engine.metrics)
    check(all(len(s) == max_new for s in streams), "a request did not finish")
    check(all(0 <= t < cfg.vocab_size for s in streams for t in s),
          "token out of range")
    shapes = engine.trace_counts
    # one shape per step function (with every lane drafting, decode-phase
    # steps all ride verify, so a speculating run may show no decode shape)
    check(shapes["prefill_chunk"] == 1 and shapes["decode"] <= 1
          and shapes["verify"] <= int(speculation), f"step shapes {shapes}")
    info = {"model": cfg.name, "num_layers": cfg.num_layers,
            "dtype": cfg.dtype, "speculation": speculation, "mode": mode,
            "block_size": block_size, "max_len": max_len,
            "tokens": ntok, "seconds": dt, "tok_s": ntok / dt,
            "steps": len(engine.metrics), "calls": calls, "launches": counts,
            "shapes": shapes, "acceptance_rate": engine.acceptance_rate(),
            "drafted_tokens": engine.metrics.total("drafted_tokens"),
            "accepted_tokens": engine.metrics.total("accepted_tokens")}
    if profile:
        info["device_busy_s"] = busy
        if cpu_profile:
            info["host_launch"] = {k: {"calls": n, "us": us}
                                   for k, (n, us) in host.items()}
    if keep_logits:
        info["logits"] = [np.stack(rows[r]) for r in rids]
        del engine._sample      # the wrapper holds the engine: free it now
    if keep_engine:
        info["engine"] = engine
    print(f"serve {cfg.name} ({cfg.num_layers} layers) {cfg.dtype} "
          f"spec={speculation} mode={mode} block={block_size}: {ntok} "
          f"tokens in {dt:.3f}s = "
          f"{ntok / dt:.1f} tok/s, {len(engine.metrics)} steps, launches "
          f"{counts}, shapes {shapes}, acceptance "
          f"{engine.acceptance_rate():.2f}")
    del engine
    torch.cuda.empty_cache()
    return streams, info


# the FMA kernels' bf16 instances count launches on their own counters but
# run under their f32 instances' names
INSTANCE_OF = {"paged_attention_bf16": "paged_attention",
               "paged_attention_mla_bf16": "paged_attention_mla"}


# f32 kernel vs plain: each emitted token's logits row within this share
# of the row's largest |logit|
LOGITS_RTOL = 1e-3


def check_logits(what: str, ker: dict, ref: dict) -> dict:
    """The f32 kernel run's logits rows against the plain run's, one row an
    emitted token (the streams are equal, so both rows saw the same
    context): max |difference| / max |plain logit| gated at LOGITS_RTOL,
    so a fault shows whatever the argmax margin.  On random weights the
    greedy streams can collapse into a few repeated tokens with a wide
    margin, which equal streams alone would not catch; the least top-1
    margin (over the same scale) and the distinct tokens a stream are
    reported beside it."""
    import numpy as np
    err, margin = 0.0, float("inf")
    for a, b in zip(ker.pop("logits"), ref.pop("logits")):
        check(a.shape == b.shape, f"{what}: logits rows {a.shape} vs "
                                  f"{b.shape}")
        scale = np.abs(b).max(axis=1)
        err = max(err, float((np.abs(a - b).max(axis=1) / scale).max()))
        top2 = np.partition(b, -2, axis=1)[:, -2:]
        margin = min(margin, float((np.abs(top2[:, 1] - top2[:, 0])
                                    / scale).min()))
    out = {"logits_max_rel_err": err, "least_top1_margin": margin}
    print(f"{what}: logits max |kernel - plain| / max |logit| = {err:.3g} "
          f"(gate {LOGITS_RTOL}), least top-1 margin {margin:.3g}",
          flush=True)
    check(err <= LOGITS_RTOL, f"{what}: logits differ by {err:.3g} of the "
                              f"row's scale (gate {LOGITS_RTOL})")
    return out


def check_serving(report, arch: str, path_kernels, f32_kernels,
                  f32_layers=None, *, bf16_layers=None, hooks=None,
                  f32_note=None, repeat=False):
    """bf16 serve (spec off, on, profiled) at full width (at `bf16_layers`
    layers if set, else full depth), then f32 kernel vs plain greedy
    streams (at `f32_layers` layers if set; skipped, with `f32_note`
    printed, when `f32_kernels` is None).  Every kernel in `path_kernels`
    must launch in the bf16 runs and no other (with device time under the
    path's names only); every kernel in `f32_kernels` must launch in the
    f32 kernel run.  bf16 greedy streams with speculation on must equal
    those with it off, at every prompt seed of SPEC_SEEDS (the reference
    guarantees it: a token's row is the same bits in a decode step and in a
    verify step), and some seed's speculating run must accept drafts.  The
    prompts hold each one's greedy continuation, or with `repeat` are one
    token repeated (`repeated_prompts`, which makes the drafter draft on
    these archs); the f32 comparison then takes `random_prompts`.  The f32
    runs' logits rows must agree too (`check_logits`).
    `hooks` ({name: fn}): each `fn(cfg, params)` runs on each model while
    it is resident (bf16, then f32), its result (None: skipped at that
    dtype) going into the report as runs[f"{name}_bf16"] / [f"{name}_f32"];
    a result's "launches" count among the kernels line's main-path
    launches."""
    import torch

    def model(dtype, num_layers=None):
        return _model(arch, dtype, num_layers)

    runs = {}
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cfg, params = model("bfloat16", bf16_layers)
    runs["bf16_params_gb"] = (torch.cuda.memory_allocated() - before) / 1e9
    # a warm-up run on random prompts (library loading, kernel attributes
    # and the caching allocator's first blocks are not the main path's
    # cost); the measured prompts then hold each one's greedy continuation,
    # so the n-gram drafter has drafts and speculation runs verify steps
    spec_equal, accepted = {}, {}
    for seed in SPEC_SEEDS:
        if repeat:
            seeded = repeated_prompts(cfg.vocab_size, seed=seed)
            serve(cfg, params, seeded, speculation=False, mode="auto")
        else:
            base = random_prompts(cfg.vocab_size, seed=seed)
            first, _ = serve(cfg, params, base, speculation=False,
                             mode="auto")
            seeded = [p + s + p[-3:] for p, s in zip(base, first)]
        off, r_off = serve(cfg, params, seeded, speculation=False,
                           mode="auto")
        on, r_on = serve(cfg, params, seeded, speculation=True, mode="auto")
        spec_equal[seed] = off == on
        accepted[seed] = r_on["accepted_tokens"]
        print(f"{arch} bf16 greedy streams spec on == off, prompt seed "
              f"{seed}: {off == on} ({r_on['accepted_tokens']} of "
              f"{r_on['drafted_tokens']} drafts accepted)", flush=True)
        if seed == SPEC_SEEDS[0]:
            prompts, plain = seeded, off
            runs["bf16"], runs["bf16_spec"] = r_off, r_on
    named = {INSTANCE_OF.get(k, k) for k in path_kernels}
    for key in ("bf16", "bf16_spec"):
        counts = runs[key]["launches"]
        check_path_launches(f"the {arch} path ({key})", counts,
                            path_kernels)
        # bf16 projections run the tensor-core gpp_matmul; the FMA one runs
        # the f32 logits head, one a step-function call, and the MoE
        # models' f32 router, one a MoE layer (three grouped launches)
        calls = runs[key]["calls"]
        check(counts["gpp_matmul"]
              == calls + counts["gpp_matmul_grouped_tc"] // 3,
              f"{arch} ({key}): {counts['gpp_matmul']} FMA gpp_matmul "
              f"launches for {calls} heads and "
              f"{counts['gpp_matmul_grouped_tc']} grouped launches")
    check(runs["bf16"]["shapes"]["decode"] == 1
          and runs["bf16_spec"]["shapes"]["verify"] == 1,
          f"{arch}: the decode or the verify shape did not run")
    check(all(spec_equal.values()),
          f"{arch}: bf16 greedy streams with speculation on differ from "
          f"those with it off at prompt seeds "
          f"{[k for k, v in spec_equal.items() if not v]}")
    check(sum(accepted.values()) > 0,
          f"{arch}: no speculating run accepted a draft ({accepted})")
    # the same bf16 run again under torch.profiler: device time by kernel,
    # over the wall time of the unprofiled run (same work, same shapes)
    again, prof = serve(cfg, params, prompts, speculation=False,
                        mode="auto", profile=True)
    check(again == plain, f"{arch}: the profiled run's streams differ")
    busy = prof["device_busy_s"]
    for k in KERNEL_NAMES:
        check((busy[k] > 0) == (k in named),
              f"{arch}: {busy[k]} s of device time under {KERNEL_NAMES[k]}")
    share = sum(busy.values()) / runs["bf16"]["seconds"]
    runs["bf16"]["device_busy_s"] = busy
    runs["bf16"]["gpp_matmul_device_s"] = busy["gpp_matmul"] + \
        busy["gpp_matmul_tc"]
    runs["bf16"]["attention_device_s"] = sum(
        v for k, v in busy.items() if k.startswith("paged_attention"))
    runs["bf16"]["device_busy_share"] = share
    runs["bf16"]["total_params"] = cfg.total_params()
    run_hooks(runs, hooks, cfg, params, "bf16")
    runs["bf16"]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"{arch} bf16 decode run device time: {busy} s; under gpp_matmul "
          f"{runs['bf16']['gpp_matmul_device_s']:.4f} s, paged attention "
          f"{runs['bf16']['attention_device_s']:.4f} s; busy share "
          f"{share:.3f} of {runs['bf16']['seconds']:.3f}s wall; "
          f"{cfg.num_layers} layers, {runs['bf16_params_gb']:.1f} GB of "
          f"weights; peak memory {runs['bf16']['peak_mem_gb']:.1f} GB")
    del params
    torch.cuda.empty_cache()

    if f32_kernels is None:
        print(f"{arch} f32 kernel-vs-plain streams: not on the card "
              f"({f32_note})")
        runs["f32_note"] = f32_note
    else:
        cfg, params = model("float32", f32_layers)
        f32_prompts = (random_prompts(cfg.vocab_size, seed=SPEC_SEEDS[0])
                       if repeat else prompts)
        f32_kernel, runs["f32_kernel"] = serve(cfg, params, f32_prompts,
                                               speculation=False,
                                               mode="auto", keep_logits=True)
        f32_ref, runs["f32_ref"] = serve(cfg, params, f32_prompts,
                                         speculation=False, mode="ref",
                                         keep_logits=True)
        check(not any(runs["f32_ref"]["launches"].values()),
              "the plain run launched a kernel")
        for k in f32_kernels:
            check(runs["f32_kernel"]["launches"][k] > 0,
                  f"{k} never launched on the {arch} f32 kernel run")
        check(f32_kernel == f32_ref,
              f"{arch} f32 greedy streams differ: kernel {f32_kernel} ref "
              f"{f32_ref}")
        runs["f32_logits"] = check_logits(f"{arch} f32", runs["f32_kernel"],
                                          runs["f32_ref"])
        runs["f32_logits"]["distinct"] = [len(set(t)) for t in f32_kernel]
        print(f"{arch} f32 greedy streams kernel == plain: True "
              f"({cfg.num_layers} layers)")
        run_hooks(runs, hooks, cfg, params, "f32")
        del params
        torch.cuda.empty_cache()
    report.setdefault("serving", {})[arch] = runs
    report.setdefault("bf16_spec_equal", {})[arch] = spec_equal
    runs["accepted_by_seed"] = accepted
    return runs


def run_hooks(runs, hooks, cfg, params, dt: str) -> None:
    for name, fn in (hooks or {}).items():
        out = fn(cfg, params)
        if out is not None:
            runs[f"{name}_{dt}"] = out


LONG_PROMPT, LONG_MAX_LEN = 1200, 1280


def window_long_run(cfg, params):
    """gemma3-12b past its window: one request with a 1,200-token prompt
    and 3 short ones, 16 new tokens each, max_len 1280 (80 blocks; the
    tensor-core plan cuts a lane's table into 8 runs of 10 blocks, so at
    decode the first run, positions 0-159, lies wholly behind the
    1024-token window and the window layers read zeroed table entries).
    bf16: speculation on == off, and the window group's blocks a lane maps
    stay at most ceil(1024 / 16) + 2 while the global group's grow with
    the context; f32: the kernel run's greedy streams equal the plain
    run's (the FMA GQA kernel at head_dim 256 with the window)."""
    import numpy as np
    from repro_torch.models import transformer as tf
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab_size, LONG_PROMPT).tolist()] + \
        random_prompts(cfg.vocab_size, requests=3, seed=13)
    horizons = tf.group_horizons(cfg)
    peak = [0] * len(horizons)

    def track(engine):
        for gi, g in enumerate(engine.kv.groups):
            peak[gi] = max([peak[gi]] + [len(g.blocks_for(lane))
                                         for lane in range(SLOTS)])

    kw = dict(max_len=LONG_MAX_LEN, on_step=track)
    out = {"prompt_tokens": [len(p) for p in prompts],
           "horizons": list(horizons)}
    if cfg.dtype == "bfloat16":
        off, r_off = serve(cfg, params, prompts, speculation=False,
                           mode="auto", **kw)
        on, r_on = serve(cfg, params, prompts, speculation=True,
                         mode="auto", **kw)
        check(off == on, f"{cfg.name} past its window: bf16 streams with "
                         "speculation on differ from those with it off")
        check(r_on["accepted_tokens"] > 0,
              f"{cfg.name} past its window: no draft accepted")
        win = math.ceil(cfg.window_size / BS) + 2
        need = math.ceil((LONG_PROMPT + 15) / BS)
        for h, p in zip(horizons, peak):
            check(p <= win if h else p >= need,
                  f"{cfg.name} past its window: group {h} mapped {p} "
                  f"blocks a lane (window bound {win}, context {need})")
        out.update(spec_equal=True, launches=r_off["launches"],
                   seconds=r_off["seconds"], tok_s=r_off["tok_s"],
                   peak_blocks_by_group=peak, window_bound=win,
                   context_blocks=need,
                   acceptance_rate=r_on["acceptance_rate"])
    else:
        ker, r_k = serve(cfg, params, prompts, speculation=False,
                         mode="auto", keep_logits=True, **kw)
        ref, r_ref = serve(cfg, params, prompts, speculation=False,
                           mode="ref", keep_logits=True, **kw)
        check(r_k["launches"]["paged_attention"] > 0,
              f"{cfg.name} past its window (f32): no FMA GQA launch")
        check(ker == ref, f"{cfg.name} past its window: f32 kernel streams "
                          f"{ker} differ from plain {ref}")
        out["logits"] = check_logits(f"{cfg.name} past its window f32",
                                     r_k, r_ref)
        out["logits"]["distinct"] = [len(set(t)) for t in ker]
        out.update(streams_equal_plain=True, launches=r_k["launches"],
                   seconds=r_k["seconds"], peak_blocks_by_group=peak)
    print(f"{cfg.name} ({cfg.num_layers} layers) {cfg.dtype} past its "
          f"window: prompts {out['prompt_tokens']}, max_len {LONG_MAX_LEN}, "
          f"blocks a lane by group {dict(zip(map(str, horizons), peak))}"
          + (f" (window bound {out['window_bound']}), spec on == off"
             if cfg.dtype == "bfloat16" else ", kernel == plain"),
          flush=True)
    return out


# ---------------------------------------------------------------------------
# slice 12: the prefix cache, telemetry and draft-model drafting on the paths
# ---------------------------------------------------------------------------

PREFIX_SYSTEM, PREFIX_MAX_LEN, PREFIX_FOLLOW = 80, 256, 8


def prefix_prompts(vocab: int, seed: int):
    """4 requests sharing an 80-token system prompt (5 blocks), each with
    its own 5-20-token suffix, and the 8 tokens each of the two follow-up
    turns appends."""
    import numpy as np
    rng = np.random.default_rng(100 + seed)
    system = rng.integers(0, vocab, PREFIX_SYSTEM).tolist()
    prompts = [system + rng.integers(0, vocab, rng.integers(5, 21)).tolist()
               for _ in range(SLOTS)]
    return prompts, [rng.integers(0, vocab, PREFIX_FOLLOW).tolist()
                     for _ in range(2)]


def serve_prefix(cfg, params, prompts, follow, *, prefix: bool, mode: str,
                 defrag: bool = True, keep_logits: bool = False,
                 max_len: int = PREFIX_MAX_LEN, max_new: int = 16,
                 track=None):
    """Two waves through one engine (4 slots, 16-token blocks, max_len
    256), the prefix cache on or off: request 0, then, once it decodes,
    requests 1-3 (their 80-token system prompt is in the index by then);
    `engine.defragment()` (with `defrag`); then two follow-up turns that
    extend requests 0 and 1's prompt + output by `follow`'s tokens (a
    match that ends inside a block, so the tail forks copy-on-write).  The
    cache's invariants are checked after every step (`track(engine)` is
    called too).  Returns (streams of both waves, info)."""
    import numpy as np
    import torch
    from repro_torch.serving.engine import ServeConfig, make_engine
    engine = make_engine(cfg, params, ServeConfig(
        slots=SLOTS, max_len=max_len, block_size=BS, prefill_chunk=CHUNK,
        prefix_cache=prefix, dense_kernel=mode, paged_attn_kernel=mode))
    rows = {}
    if keep_logits:
        sample = engine._sample

        def keep(logits_row, req):
            rows.setdefault(req.rid, []).append(
                np.array(logits_row, dtype=np.float32))
            return sample(logits_row, req)
        engine._sample = keep

    def step():
        engine.step()
        engine.kv.check_invariants(
            engine.prefix.held_blocks() if engine.prefix else None)
        if track is not None:
            track(engine)

    torch.cuda.synchronize()
    for c in counters().values():
        c.n = 0
    t0 = time.perf_counter()
    rids = [engine.submit(prompts[0], max_new_tokens=max_new)]
    while engine.result(rids[0]) is None and \
            engine.scheduler.phase.get(0) != "decode":
        step()
    rids += [engine.submit(p, max_new_tokens=max_new) for p in prompts[1:]]
    while engine.pending:
        step()
    first = [engine.result(r) for r in rids]
    if defrag:
        engine.defragment()
        engine.kv.check_invariants(
            engine.prefix.held_blocks() if engine.prefix else None)
    later = [engine.submit(prompts[i] + first[i] + f, max_new_tokens=max_new)
             for i, f in enumerate(follow)]
    while engine.pending:
        step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    streams = first + [engine.result(r) for r in later]
    counts = {k: c.n for k, c in counters().items()}
    check(all(s is not None and len(s) == max_new for s in streams),
          f"{cfg.name} prefix={prefix}: a request did not finish")
    shapes = engine.trace_counts
    check(shapes["prefill_chunk"] == 1 and shapes["decode"] == 1
          and shapes["verify"] == 0, f"{cfg.name} prefix: shapes {shapes}")
    m = engine.metrics
    ntok = sum(len(x) for x in streams)
    info = {"prefix": prefix, "defrag": defrag, "mode": mode,
            "dtype": cfg.dtype, "num_layers": cfg.num_layers,
            "tokens": ntok, "seconds": dt, "tok_s": ntok / dt,
            "steps": len(m), "launches": counts, "shapes": shapes,
            "hit_rate": engine.prefix_hit_rate(),
            "hit_tokens": m.total("prefix_hit_tokens"),
            "prefix_saved_bytes": m.total("prefix_saved_bytes"),
            "prefill_tokens": m.total("prefill_tokens"),
            "blocks_shared_peak": max(r["blocks_shared"] for r in m)}
    if keep_logits:
        info["logits"] = [np.stack(rows[r]) for r in rids + later]
        del engine._sample
    del engine
    torch.cuda.empty_cache()
    return streams, info


def prefix_serving(cfg, params):
    """The prefix cache on the path (`serve_prefix`), prefix on against off:
    bf16 at prompt seeds 0-2 (streams equal; seed 0 also without the
    `defragment`: the same streams), f32 at seed 0 with the kernels
    (streams equal, each emitted token's logits row within LOGITS_RTOL of
    the off run's).  Gates: some hit (hit rate > 0), the cache's
    invariants after every step, three step shapes.  Reports hit tokens,
    prefill tokens saved, `prefix_saved_bytes` and tok/s on vs off."""
    bf16 = cfg.dtype == "bfloat16"
    out = {}
    for seed in (SPEC_SEEDS if bf16 else SPEC_SEEDS[:1]):
        prompts, follow = prefix_prompts(cfg.vocab_size, seed)
        off, r_off = serve_prefix(cfg, params, prompts, follow, prefix=False,
                                  mode="auto", keep_logits=not bf16)
        on, r_on = serve_prefix(cfg, params, prompts, follow, prefix=True,
                                mode="auto", keep_logits=not bf16)
        check(r_on["hit_rate"] > 0 and r_on["hit_tokens"] > 0,
              f"{cfg.name} prefix seed {seed}: no hit")
        row = {"streams_equal": on == off, "on": r_on, "off": r_off,
               "prefill_tokens_saved": r_off["prefill_tokens"]
               - r_on["prefill_tokens"]}
        if not bf16:
            row["logits"] = check_logits(f"{cfg.name} f32 prefix on vs off",
                                         r_on, r_off)
        if seed == SPEC_SEEDS[0]:
            plain, _ = serve_prefix(cfg, params, prompts, follow,
                                    prefix=True, mode="auto", defrag=False)
            check(plain == on, f"{cfg.name} prefix: streams differ with and "
                               "without defragment")
            row["defragment_transparent"] = True
        out[seed] = row
        print(f"{cfg.name} ({cfg.num_layers} layers) {cfg.dtype} prefix "
              f"seed {seed}: on == off {on == off}; hit rate "
              f"{r_on['hit_rate']:.2f}, {r_on['hit_tokens']} hit tokens, "
              f"{row['prefill_tokens_saved']} prefill tokens saved, "
              f"prefix_saved_bytes {r_on['prefix_saved_bytes']}, peak "
              f"shared blocks {r_on['blocks_shared_peak']}; tok/s on "
              f"{r_on['tok_s']:.1f} off {r_off['tok_s']:.1f}", flush=True)
    unequal = [k for k, v in out.items() if not v["streams_equal"]]
    check(not unequal, f"{cfg.name} {cfg.dtype}: prefix on != off at prompt "
                       f"seeds {unequal}")
    first = out[SPEC_SEEDS[0]]
    return {"by_seed": out, "launches": first["on"]["launches"],
            "tok_s_on": first["on"]["tok_s"],
            "tok_s_off": first["off"]["tok_s"]}


PREFIX_LONG = 1100          # gemma3-12b: a shared prefix past its window


def prefix_long_run(cfg, params):
    """gemma3-12b (bf16): two requests sharing a 1,100-token prefix past
    its 1024-token window, max_len 1280 — request 0 is the prefix itself,
    request 1 (submitted once request 0 decodes) the prefix and 20 more
    tokens, so its hit maps the window group's zeroed (expired) entries
    and forks the 12-token tail; two short requests beside them.  Gates:
    prefix on == off, a hit of at least 1,088 tokens, and the window
    group's blocks a lane at most ceil(1024 / 16) + 2."""
    if cfg.dtype != "bfloat16":
        return None
    import numpy as np
    from repro_torch.models import transformer as tf
    rng = np.random.default_rng(21)
    doc = rng.integers(0, cfg.vocab_size, PREFIX_LONG).tolist()
    prompts = [doc, doc + rng.integers(0, cfg.vocab_size, 20).tolist()] + \
        random_prompts(cfg.vocab_size, requests=2, seed=22)
    horizons = tf.group_horizons(cfg)
    win = math.ceil(cfg.window_size / BS) + 2
    out = {}
    for prefix in (False, True):
        peak = [0] * len(horizons)

        def track(engine):
            for gi, g in enumerate(engine.kv.groups):
                peak[gi] = max([peak[gi]] + [len(g.blocks_for(lane))
                                             for lane in range(SLOTS)])

        streams, info = serve_prefix(cfg, params, prompts, (), prefix=prefix,
                                     mode="auto", defrag=False,
                                     max_len=LONG_MAX_LEN, track=track)
        for h, p in zip(horizons, peak):
            if h:
                check(p <= win, f"{cfg.name} shared prefix past its window: "
                                f"{p} window blocks a lane (bound {win})")
        info["peak_blocks_by_group"] = peak
        out["on" if prefix else "off"] = (streams, info)
    (off, r_off), (on, r_on) = out["off"], out["on"]
    check(on == off, f"{cfg.name} shared prefix past its window: bf16 "
                     "prefix on != off")
    check(r_on["hit_tokens"] >= PREFIX_LONG // BS * BS,
          f"{cfg.name} shared prefix past its window: hit "
          f"{r_on['hit_tokens']} tokens")
    by_group = dict(zip(map(str, horizons), r_on["peak_blocks_by_group"]))
    print(f"{cfg.name} shared {PREFIX_LONG}-token prefix past its window: "
          f"on == off True, {r_on['hit_tokens']} hit tokens, blocks a lane "
          f"by group {by_group} (window bound {win}), tok/s on "
          f"{r_on['tok_s']:.1f} off "
          f"{r_off['tok_s']:.1f}", flush=True)
    return {"on": r_on, "off": r_off, "launches": r_on["launches"],
            "window_bound": win}


OBS_REPEATS = 5


def obs_run(cfg, params):
    """Telemetry on qwen1.5-0.5b (bf16): obs on == off streams; the trace,
    written and parsed back, holds a span for every request and every
    step and the modelled kernel lanes; TTFT / TPOT p50 / p99 finite; the
    utilization report; the overhead (obs on against off, interleaved,
    best of 5 each: printed, not gated: wall times move 2x with the host);
    and the host time of a step split into its parts (`engine.host_us`,
    the obs laps) beside the CUDA runtime calls of a profiled run."""
    if cfg.dtype != "bfloat16":
        return None
    import torch
    from repro_torch.obs.trace import (PID_KERNEL, PID_REQUESTS,
                                       TID_COMPUTE, TID_DMA)
    prompts = random_prompts(cfg.vocab_size, seed=SPEC_SEEDS[0])
    off, _ = serve(cfg, params, prompts, speculation=False, mode="auto")
    on, r_on = serve(cfg, params, prompts, speculation=False, mode="auto",
                     engine_kw=dict(obs=True), keep_engine=True)
    check(on == off, f"{cfg.name}: obs on changes the streams")
    engine = r_on.pop("engine")
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(REPORT_DIR or tmp) / "obs_trace.json"
        engine.obs.write_trace(str(path))
        evs = json.loads(path.read_text())["traceEvents"]
    steps = [e for e in evs if e.get("name") == "step" and e["ph"] == "X"]
    reqs = {ph: sorted(e["id"] for e in evs if e["ph"] == ph
                       and e["pid"] == PID_REQUESTS) for ph in "be"}
    lanes = {e["tid"] for e in evs if e["pid"] == PID_KERNEL
             and e["ph"] == "X"}
    check(len(steps) == len(engine.metrics)
          and reqs["b"] == reqs["e"] == list(range(len(prompts)))
          and lanes == {TID_DMA, TID_COMPUTE},
          f"{cfg.name} trace: {len(steps)} step spans for "
          f"{len(engine.metrics)} steps, requests {reqs}, lanes {lanes}")
    req = engine.obs.requests.summary()
    lat = {k: {q: req[k][q] for q in ("p50", "p99", "count")}
           for k in ("ttft", "tpot")}
    check(all(math.isfinite(v[q]) for v in lat.values()
              for q in ("p50", "p99")), f"{cfg.name}: TTFT / TPOT {lat}")
    util = engine.metrics.utilization_report()
    steps_n = len(engine.metrics)
    split = {k: v / steps_n for k, v in engine.host_us.items()}
    wall = engine.metrics.total("step_wall_us") / steps_n
    del engine
    # overhead: obs on and off in turns, best of OBS_REPEATS each
    best = {False: [], True: []}
    for _ in range(OBS_REPEATS):
        for flag in (False, True):
            _, r = serve(cfg, params, prompts, speculation=False,
                         mode="auto", engine_kw=dict(obs=flag))
            best[flag].append(r["tok_s"])
    overhead = 1.0 - max(best[True]) / max(best[False])
    # the CUDA runtime calls of one profiled obs run (host side)
    _, prof = serve(cfg, params, prompts, speculation=False, mode="auto",
                    engine_kw=dict(obs=True), profile=True,
                    cpu_profile=True)
    out = {"streams_equal": True, "trace_events": len(evs),
           "step_spans": len(steps), "latency_s": lat,
           "utilization": util, "tok_s_off": best[False],
           "tok_s_on": best[True], "overhead": overhead,
           "host_us_per_step": split, "step_wall_us": wall,
           "host_launch": prof.get("host_launch", {}),
           "launches": r_on["launches"]}
    print(f"{cfg.name} obs: on == off True; trace {len(evs)} events, "
          f"{len(steps)} step spans; TTFT / TPOT {lat}; utilization "
          f"{util}; tok/s best of {OBS_REPEATS} off {max(best[False]):.1f} "
          f"on {max(best[True]):.1f}: overhead {overhead:.4f} (target "
          f"< 0.05); host us a step {split} of {wall:.1f}; runtime calls "
          f"{out['host_launch']}", flush=True)
    return out


def draft_forward_check(dcfg, dserved, toks):
    """The draft model's forward over one (1, 16) window with the kernels
    (gpp_matmul_tc, RMSNorm and the f32 FMA head at 16 rows) against the
    plain versions (`dense_kernel="ref"`) on the same tokens.  Gated block
    by block on the plain run's input, so one block's bf16 rounding does
    not carry into the next: each row of a block's output within TOL's
    bf16 rtol of its largest |plain| value, and the head on the plain
    run's last hidden state, each logits row within LOGITS_RTOL of its
    largest |plain logit|.  The whole forward's rows, where bf16 rounding
    does carry through 24 blocks, are reported beside the plain bf16
    forward's distance from an f32 one (bf16's own spread), not gated.
    The kernel forward launches those three kernels and no other, the
    plain one none."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as tf

    def row_err(a, b):
        a, b = a.float().flatten(0, -2), b.float().flatten(0, -2)
        return float(((a - b).abs().amax(dim=1)
                      / b.abs().amax(dim=1)).max())

    def f32(tree):
        if isinstance(tree, dict):
            return {k: f32(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(f32(v) for v in tree)
        return tree.float() if tree.is_floating_point() else tree

    want = ("gpp_matmul_tc", "gpp_matmul", "rmsnorm")
    rcfg = dataclasses.replace(dcfg, dense_kernel="ref")
    full = {}
    for mode, cfg in (("auto", dcfg), ("ref", rcfg)):
        before = {k: c.n for k, c in counters().items()}
        with torch.no_grad():
            logits = tf.forward(dserved, cfg, {"tokens": toks})
        torch.cuda.synchronize()
        ran = {k: c.n - before[k] for k, c in counters().items()}
        check(all((n > 0) == (mode == "auto" and k in want)
                  for k, n in ran.items()),
              f"the draft forward ({mode}) launched {ran}")
        check(tuple(logits.shape) == (1, DRAFT_WINDOW, dcfg.vocab_size)
              and bool(torch.isfinite(logits).all()),
              f"the draft forward ({mode}): logits {tuple(logits.shape)}")
        full[mode] = logits
    with torch.no_grad():
        x = tf._embed_tokens(dserved, dcfg, toks)
        pos = torch.arange(DRAFT_WINDOW, device="cuda")[None]
        block_err = 0.0
        for kind, p in tf._tree_layers(dserved, dcfg):
            plain = tf.apply_block(rcfg, kind, p, x, pos)
            block_err = max(block_err, row_err(
                tf.apply_block(dcfg, kind, p, x, pos), plain))
            x = plain
        head_err = row_err(tf._logits_head(dserved, dcfg, x),
                           tf._logits_head(dserved, rcfg, x))
        exact = tf.forward(f32(dserved), dataclasses.replace(
            rcfg, dtype="float32"), {"tokens": toks})
    out = {"block_max_rel_err": block_err, "block_tol": TOL["bfloat16"][1],
           "head_max_rel_err": head_err, "head_tol": LOGITS_RTOL,
           "forward_max_rel_err": row_err(full["auto"], full["ref"]),
           "plain_bf16_vs_f32": row_err(full["ref"], exact),
           "kernel_bf16_vs_f32": row_err(full["auto"], exact)}
    print(f"draft forward {dcfg.name} (1, {DRAFT_WINDOW}) bf16, max |kernel "
          f"- plain| / a row's max |plain|: blocks {block_err:.3g} (gate "
          f"{TOL['bfloat16'][1]}), head {head_err:.3g} (gate "
          f"{LOGITS_RTOL}); the whole forward {out['forward_max_rel_err']:.3g}"
          f" (bf16 from f32: plain {out['plain_bf16_vs_f32']:.3g}, kernels "
          f"{out['kernel_bf16_vs_f32']:.3g})", flush=True)
    check(block_err <= TOL["bfloat16"][1],
          f"the draft forward: a block's rows differ by {block_err:.3g}")
    check(head_err <= LOGITS_RTOL,
          f"the draft forward: the head's rows differ by {head_err:.3g}")
    return out


def draft_run(cfg, params):
    """qwen2-7b (bf16, resident) with draft-model drafting: full-width
    qwen1.5-0.5b (random weights from seed 0; vocabularies 151936 and
    152064, drafts clamped) drafts for it.  Gates, at prompt seeds 0-2:
    the streams equal speculation off's, and each run launches exactly the
    path's kernels (the draft forward: tensor-core gpp_matmul, the FMA
    head, RMSNorm).  Then qwen1.5-0.5b drafts for itself (the same
    weights): streams equal speculation off's, and drafts are accepted.
    Prints the draft forward's device time (profiler, one (1, 16) window)
    times the forwards a verify step ran, and tok/s with model drafting,
    n-gram self-drafting and none."""
    if cfg.dtype != "bfloat16":
        return None
    import torch
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    dcfg = registry.get_config("qwen1.5-0.5b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    dparams = tf.init_params(dcfg, gen, "cuda")
    path = ("gpp_matmul_tc", "gpp_matmul", "paged_attention_tc",
            "paged_attention_merge", "rmsnorm")
    model_kw = dict(engine_kw=dict(draft_source="model"),
                    draft_model=(dcfg, dparams), keep_engine=True)
    out = {"by_seed": {}}

    def launched_only_path(info, what):
        for k, n in info["launches"].items():
            check((n > 0) == (k in path),
                  f"{k} launched {n} times on {what}")

    for seed in SPEC_SEEDS:
        prompts = repeated_prompts(cfg.vocab_size, seed=seed)
        off, r_off = serve(cfg, params, prompts, speculation=False,
                           mode="auto")
        on, r_on = serve(cfg, params, prompts, speculation=True,
                         mode="auto", **model_kw)
        engine = r_on.pop("engine")
        verify_steps = sum(m["verify_tokens"] > 0 for m in engine.metrics)
        r_on["draft_forwards"] = engine.draft_forwards
        r_on["verify_steps"] = verify_steps
        del engine
        check(on == off, f"{cfg.name} drafted by {dcfg.name}: streams with "
                         f"the draft model differ from speculation off "
                         f"(prompt seed {seed})")
        launched_only_path(r_on, f"{cfg.name} with a draft model")
        out["by_seed"][seed] = {"streams_equal": True,
                                "accepted": r_on["accepted_tokens"],
                                "drafted": r_on["drafted_tokens"],
                                "draft_forwards": r_on["draft_forwards"],
                                "verify_steps": verify_steps}
        if seed == SPEC_SEEDS[0]:
            out["launches"] = r_on["launches"]
            ngram, r_ng = serve(cfg, params, prompts, speculation=True,
                                mode="auto")
            check(ngram == off, f"{cfg.name}: n-gram drafts change streams")
            out["tok_s"] = {"model": r_on["tok_s"], "self": r_ng["tok_s"],
                            "none": r_off["tok_s"]}
            fwd_per_verify = r_on["draft_forwards"] / max(1, verify_steps)
    # the draft forward on one (1, 16) window: against its plain version,
    # then its device time
    toks = torch.randint(0, dcfg.vocab_size, (1, DRAFT_WINDOW),
                         device="cuda", generator=torch.Generator(
                             device="cuda").manual_seed(5))
    dserved = tf.serving_params(dparams, dcfg)
    out["forward_vs_plain"] = draft_forward_check(dcfg, dserved, toks)
    with torch.no_grad():
        fwd_ms = device_ms(lambda: tf.forward(dserved, dcfg,
                                              {"tokens": toks}), [()],
                           iters=20)
    del dserved
    out["draft_forward_ms"] = fwd_ms
    out["draft_forwards_per_verify_step"] = fwd_per_verify
    out["draft_device_ms_per_verify_step"] = fwd_ms * fwd_per_verify
    # qwen1.5-0.5b drafting for itself: the same weights, as the target
    prompts = repeated_prompts(dcfg.vocab_size, seed=SPEC_SEEDS[0])
    off, _ = serve(dcfg, dparams, prompts, speculation=False, mode="auto")
    on, r_self = serve(dcfg, dparams, prompts, speculation=True,
                       mode="auto", **model_kw)
    del r_self["engine"]
    check(on == off, f"{dcfg.name} drafting for itself: streams differ")
    check(r_self["accepted_tokens"] > 0,
          f"{dcfg.name} drafting for itself: no draft accepted")
    launched_only_path(r_self, f"{dcfg.name} drafting for itself")
    out["self_draft"] = {"streams_equal": True,
                         "accepted": r_self["accepted_tokens"],
                         "drafted": r_self["drafted_tokens"],
                         "tok_s": r_self["tok_s"]}
    del dparams
    torch.cuda.empty_cache()
    print(f"{cfg.name} drafted by full-width {dcfg.name}: streams == "
          f"speculation off at seeds {list(SPEC_SEEDS)}; "
          f"{out['by_seed']}; draft forward {fwd_ms:.4f} ms device x "
          f"{fwd_per_verify:.2f} a verify step = "
          f"{out['draft_device_ms_per_verify_step']:.4f} ms; tok/s "
          f"{out['tok_s']}; {dcfg.name} drafting for itself: "
          f"{out['self_draft']}", flush=True)
    return out


def check_mla_block_sizes(report):
    """deepseek-v2-lite-16b at full width, 4 of its 27 layers (1 dense + 3
    MoE), served with 8- and 128-token KV blocks, which the tensor-core MLA
    kernel does not take: bf16 must run the FMA MLA kernel's bf16 instance
    (its own count) and its merge, and neither tensor-core MLA kernel nor
    the f32 instance; f32 at 8- and 128-token blocks (the FMA kernel
    streams a block in pieces) must run the f32 instance and its merge and
    give the plain run's greedy streams.  The bf16 streams are set beside
    the plain bf16 run's, not gated (bf16 rounds differently in the
    two)."""
    import torch
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    arch = "deepseek-v2-lite-16b"
    out = {}
    for dtype, sizes in (("bfloat16", (8, 128)), ("float32", (8, 128))):
        cfg = registry.get_config(arch).with_(dtype=dtype, num_layers=4)
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = tf.init_params(cfg, gen, "cuda")
        prompts = random_prompts(cfg.vocab_size)
        mla = ("paged_attention_mla_bf16" if dtype == "bfloat16"
               else "paged_attention_mla")
        for bs in sizes:
            streams, info = serve(cfg, params, prompts, speculation=False,
                                  mode="auto", block_size=bs)
            c = info["launches"]
            check(c[mla] > 0 and c["paged_attention_merge"] > 0 and all(
                c[k] == 0 for k in ("paged_attention_mla_tc",
                                    "paged_attention_mla",
                                    "paged_attention_mla_bf16") if k != mla),
                  f"{arch} {dtype} block {bs}: MLA launches {c}")
            plain, _ = serve(cfg, params, prompts, speculation=False,
                             mode="ref", block_size=bs)
            equal = streams == plain
            if dtype == "float32":
                check(equal, f"{arch} f32 block {bs}: kernel streams "
                             f"{streams} differ from plain {plain}")
            out[f"{dtype} block {bs}"] = {
                "launches": c, "tok_s": info["tok_s"],
                "streams_equal_plain": equal}
            print(f"{arch} (4 layers) {dtype} block {bs}: {c[mla]} {mla} "
                  f"launches, greedy streams == plain: {equal}"
                  + ("" if dtype == "float32" else " (bf16: not gated)"))
        del params
        torch.cuda.empty_cache()
    report["mla_block_sizes"] = out
    return out


# ---------------------------------------------------------------------------
# slice 13: the dense-cache engine and the four non-paged archs
# ---------------------------------------------------------------------------

# published widths (configs/): zamba2-2.7b (d, d_inner, state, heads, d_ff,
# vocab), xlstm-1.3b (d, heads, vocab), llama-3.2-vision-11b (d, heads, kv
# heads, head_dim, d_ff, vocab, patch embeddings), musicgen-large (d, d_ff,
# vocab)
Z_D, Z_DI, Z_N, Z_H, Z_F, Z_V = 2560, 5120, 64, 32, 10240, 32000
X_D, X_H, X_V = 2048, 4, 50304
LV_D, LV_H, LV_KV, LV_HD, LV_F, LV_V, LV_T = (4096, 32, 8, 128, 14336,
                                              128256, 1600)
MG_D, MG_F, MG_V = 2048, 8192, 2048
STEP_B, STEP_S, STEP_NEW = 4, 32, 16   # the step runs: batch, prompt, steps
DENSE_LENGTHS = (6, 9, 12, 15)         # served prompts: 4 position groups
# gpp_matmul on the new paths, (path, projection): (decode rows, prefill
# rows, K, N, activation).  xlstm's w_o contracts (4 heads x 512) through
# `ops.dense(contract_dims=2)` (checked there too); llama-vision's cross
# K/V project every patch embedding of the 4 rows at every step
DENSE_GPP = {
    ("zamba2-2.7b", "w_in"): (SLOTS, 15, Z_D, 2 * Z_DI, None),
    ("zamba2-2.7b", "w_bc"): (SLOTS, 15, Z_D, 2 * Z_N, None),
    ("zamba2-2.7b", "w_dt"): (SLOTS, 15, Z_D, Z_H, None),
    ("zamba2-2.7b", "w_out"): (SLOTS, 15, Z_DI, Z_D, None),
    ("zamba2-2.7b", "shared q/k/v/o"): (SLOTS, 15, Z_D, Z_D, None),
    ("zamba2-2.7b", "shared gate"): (SLOTS, 15, Z_D, Z_F, "silu"),
    ("zamba2-2.7b", "shared down"): (SLOTS, 15, Z_F, Z_D, None),
    ("xlstm-1.3b", "w_q/k/v/o, w_z, w_out"): (SLOTS, 15, X_D, X_D, None),
    ("xlstm-1.3b", "w_i / w_f"): (SLOTS, 15, X_D, X_H, None),
    ("xlstm-1.3b", "ogate / w_og"): (SLOTS, 15, X_D, X_D, "sigmoid"),
    ("musicgen-large", "q/k/v/o"): (STEP_B, STEP_B * STEP_S, MG_D, MG_D,
                                    None),
    ("musicgen-large", "w_up"): (STEP_B, STEP_B * STEP_S, MG_D, MG_F,
                                 "gelu"),
    ("musicgen-large", "w_down"): (STEP_B, STEP_B * STEP_S, MG_F, MG_D,
                                   None),
    ("llama-3.2-vision-11b", "q / o"): (STEP_B, STEP_B * STEP_S, LV_D, LV_D,
                                        None),
    ("llama-3.2-vision-11b", "k / v"): (STEP_B, STEP_B * STEP_S, LV_D,
                                        LV_KV * LV_HD, None),
    ("llama-3.2-vision-11b", "gate"): (STEP_B, STEP_B * STEP_S, LV_D, LV_F,
                                       "silu"),
    ("llama-3.2-vision-11b", "down"): (STEP_B, STEP_B * STEP_S, LV_F, LV_D,
                                       None),
    ("llama-3.2-vision-11b", "cross k / v"): (STEP_B * LV_T, STEP_B * LV_T,
                                              LV_D, LV_KV * LV_HD, None),
}
DENSE_HEADS = {"zamba2-2.7b": (Z_D, Z_V), "xlstm-1.3b": (X_D, X_V),
               "llama-3.2-vision-11b": (LV_D, LV_V),
               "musicgen-large": (MG_D, MG_V)}
# the cross layers' per-head q / k RMSNorm: rows of head_dim 128 (q at a
# decode step and at prefill, k over every patch embedding)
CROSS_NORM_ROWS = (STEP_B * LV_H, STEP_B * STEP_S * LV_H,
                   STEP_B * LV_T * LV_KV)
# the kernels of the new paths: bf16 projections on the tensor-core
# gpp_matmul, the f32 logits head on its FMA route, RMSNorm; f32 runs the
# FMA route for every projection; no attention or grouped kernel
DENSE_PATH = ("gpp_matmul_tc", "gpp_matmul", "rmsnorm")
DENSE_F32 = ("gpp_matmul", "rmsnorm")


def check_dense_gpp(report):
    """gpp_matmul at every new projection shape (decode and prefill rows,
    bf16 and f32, the fused silu / gelu / sigmoid epilogues), xlstm's
    contract_dims=2 output projection through `ops.dense`, the RMSNorm
    kernel at the cross layers' 128-wide per-head rows, each against its
    plain version; the bf16 decode shapes and the four f32 logits heads
    timed beside torch.matmul and their bound."""
    import torch
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.ref import dense_ref, rmsnorm_ref
    rows, err = [], {"tc": 0.0, "fma": 0.0}
    for (path, proj), (m_dec, m_pre, K, N, act) in DENSE_GPP.items():
        errs = {}
        for M in dict.fromkeys((m_dec, m_pre)):
            for dtype in BOTH:
                e = gpp_case(M, K, N, dtype, act=act, seed=M + N)
                key = "tc" if dtype == "bfloat16" else "fma"
                err[key] = max(err[key], e)
                errs[M, dtype] = e
                rows.append({"path": path, "proj": proj, "M": M, "K": K,
                             "N": N, "act": act, "dtype": dtype,
                             "max_abs_err": e})
                if (M, dtype) == (m_dec, "bfloat16"):
                    row = rows[-1]
        row.update(gpp_time(m_dec, K, N, "bfloat16"))
        row["plan"] = str(gm._plan("tc", m_dec, K, N, 2, None))
        print(f"gpp_matmul {path} {proj} {m_dec}x{K}x{N} act={act}: "
              f"max_abs_err (rows, dtype) "
              f"{ {f'{m} {d}': round(v, 6) for (m, d), v in errs.items()} }"
              f"; bf16 ms={row['ms']:.4f} library_ms="
              f"{row['library_ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']}) plan "
              f"{row['plan']}", flush=True)
    # xlstm's output projection: (B, 4, 512) heads contracted against the
    # (4, 512, 2048) weight in one launch
    g = torch.Generator(device="cuda").manual_seed(21)
    for dtype in BOTH:
        dt = getattr(torch, dtype)
        x = torch.randn(SLOTS, X_H, X_D // X_H, generator=g,
                        device="cuda").to(dt)
        w = (torch.randn(X_H, X_D // X_H, X_D, generator=g, device="cuda")
             * 0.02).to(dt)
        before = gm.launches_tc.n + gm.launches.n
        y = ops.dense(x, w, contract_dims=2)
        ref = dense_ref(x.reshape(SLOTS, X_D), w.reshape(X_D, X_D))
        check(gm.launches_tc.n + gm.launches.n - before == 1,
              "contract_dims=2 took other than one launch")
        d = (y.float() - ref.float()).abs()
        atol, rtol = TOL[dtype]
        check(bool((d <= atol + rtol * ref.float().abs()).all()),
              f"xlstm w_o contract_dims=2 {dtype}: max err {float(d.max())}")
        rows.append({"path": "xlstm-1.3b", "proj": "w_o contract_dims=2",
                     "M": SLOTS, "K": X_D, "N": X_D, "dtype": dtype,
                     "max_abs_err": float(d.max())})
    heads = {}
    for arch, (K, N) in DENSE_HEADS.items():
        heads[arch] = head_time(SLOTS, K, N)
        h = heads[arch]
        print(f"f32 logits head {arch} {SLOTS}x{K}x{N}: ms={h['ms']:.4f} "
              f"library_ms={h['library_ms']:.4f} plain_ms="
              f"{h['plain_ms']:.4f} bound_ms={h['bound_ms']:.5f}",
              flush=True)
    norms = []
    for n in CROSS_NORM_ROWS:
        for dtype in BOTH:
            dt = getattr(torch, dtype)
            x = (torch.randn(n, LV_HD, generator=g, device="cuda") * 2).to(dt)
            scale = (1 + 0.1 * torch.randn(LV_HD, generator=g,
                                           device="cuda")).to(dt)
            e, ok = rms_err(rn.rmsnorm(x, scale, RMS_EPS),
                            rmsnorm_ref(x, scale, RMS_EPS), dtype)
            check(ok, f"rmsnorm {n} rows of {LV_HD} {dtype}: max err {e}")
            norms.append({"rows": n, "width": LV_HD, "dtype": dtype,
                          "max_abs_err": e})
    print(f"rmsnorm at the cross layers' per-head rows ({LV_HD} wide, "
          f"{CROSS_NORM_ROWS} rows, f32 and bf16): max_abs_err "
          f"{max(r['max_abs_err'] for r in norms):.3g}", flush=True)
    report["dense_gpp"] = {"shapes": rows, "heads": heads,
                           "cross_norm": norms}
    return rows, err, heads, norms


def dense_prompts(vocab: int, seed: int = 0):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in DENSE_LENGTHS]


def _profiled(run, profile: bool):
    """run() under torch.profiler when asked: (result, device seconds by
    kernel name) — None without a profile."""
    import torch
    if not profile:
        return run(), None
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    busy = dict.fromkeys([*KERNEL_NAMES, "other"], 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = next((k for k, v in KERNEL_NAMES.items() if v in e.name),
                       "other")
            busy[key] += e.time_range.elapsed_us() / 1e6
    return out, busy


def dense_serve(cfg, params, prompts, *, mode: str, profile=False,
                keep_logits=False, max_new: int = 16):
    """Serve `prompts` through the dense-cache engine (4 slots, max_len
    128).  info: tokens, seconds, launches, step-function calls, shapes,
    and with `keep_logits` each request's f32 logits rows (one an emitted
    token, the row it was sampled from)."""
    import numpy as np
    import torch
    from repro_torch.serving import dense_engine as de
    from repro_torch.serving.engine import ServeConfig

    engine = de.DenseServingEngine(cfg, params, ServeConfig(
        slots=SLOTS, max_len=MAX_LEN, dense_kernel=mode))
    calls = {"prefill": 0, "decode": 0}

    def counted(name, fn):
        def call(*a):
            calls[name] += 1
            return fn(*a)
        return call
    engine._prefill = counted("prefill", engine._prefill)
    engine._decode = counted("decode", engine._decode)
    rows, sample = {}, de.sample_token
    if keep_logits:
        def keep(serve_cfg, rid, idx, row):
            rows.setdefault(rid, []).append(np.array(row, np.float32))
            return sample(serve_cfg, rid, idx, row)
        de.sample_token = keep
    try:
        torch.cuda.synchronize()
        for c in counters().values():
            c.n = 0

        def run():
            t0 = time.perf_counter()
            rids = [engine.submit(p, max_new_tokens=max_new)
                    for p in prompts]
            res = engine.run()
            torch.cuda.synchronize()
            return [res[r] for r in rids], time.perf_counter() - t0
        (streams, dt), busy = _profiled(run, profile)
    finally:
        de.sample_token = sample
    counts = {k: c.n for k, c in counters().items()}
    ntok = sum(len(s) for s in streams)
    check(all(len(s) == max_new for s in streams), "a request did not finish")
    check(all(0 <= t < cfg.vocab_size for s in streams for t in s),
          "token out of range")
    shapes = engine.trace_counts
    check(shapes == {"prefill": len(set(map(len, prompts))), "decode": 1},
          f"{cfg.name} dense engine step shapes {shapes}")
    decode_steps = sum(m["decode_tokens"] > 0 for m in engine.metrics)
    check(calls["decode"] > decode_steps,
          f"{cfg.name}: decode ran one position group a step "
          f"({calls['decode']} calls, {decode_steps} steps)")
    info = {"model": cfg.name, "num_layers": cfg.num_layers,
            "dtype": cfg.dtype, "mode": mode, "engine": "dense",
            "tokens": ntok, "seconds": dt, "tok_s": ntok / dt,
            "steps": len(engine.metrics), "calls": calls, "launches": counts,
            "shapes": shapes, "flatness_cov": engine.flatness_cov()}
    if busy is not None:
        info["device_busy_s"] = busy
    if keep_logits:
        info["logits"] = [np.stack(rows[r]) for r in range(len(prompts))]
    print(f"dense serve {cfg.name} ({cfg.num_layers} layers) {cfg.dtype} "
          f"mode={mode}: {ntok} tokens in {dt:.3f}s = {ntok / dt:.1f} tok/s, "
          f"{len(engine.metrics)} steps, calls {calls}, launches {counts}, "
          f"shapes {shapes}", flush=True)
    # the counting wrappers hold the engine: free it now, not at a later
    # garbage collection
    del engine._prefill, engine._decode, engine
    torch.cuda.empty_cache()
    return streams, info


def check_path_launches(what: str, counts: dict, path) -> None:
    """Every kernel of `path` launched, none outside it."""
    for k, n in counts.items():
        check((n > 0) == (k in path), f"{k} launched {n} times on {what}")


def check_busy(what: str, busy: dict, path, seconds: float) -> float:
    """Device time only under the path's kernels; prints it by kernel and
    returns the busy share of `seconds`."""
    named = {INSTANCE_OF.get(k, k) for k in path}
    for k in KERNEL_NAMES:
        check((busy[k] > 0) == (k in named),
              f"{what}: {busy[k]} s of device time under {KERNEL_NAMES[k]}")
    share = sum(busy.values()) / seconds
    print(f"{what} device time: "
          f"{ {k: round(v, 6) for k, v in busy.items() if v} } s, busy "
          f"share {share:.3f} of {seconds:.3f}s wall", flush=True)
    return share


def _model(arch: str, dtype: str, num_layers=None):
    """Full-width `arch` in `dtype` (at `num_layers` if set), random
    weights from seed 0, on the card."""
    import torch
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    cfg = registry.get_config(arch).with_(dtype=dtype)
    if num_layers:
        cfg = cfg.with_(num_layers=num_layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    return cfg, tf.init_params(cfg, gen, "cuda")


def check_dense_serving(report, arch: str, label=None, num_layers=None):
    """The dense-cache engine at full width and depth (at `num_layers` if
    set): bf16 with the
    kernels (a warm-up, the measured run, the same run profiled) and
    plain (its streams' agreement reported), then f32 with the kernels
    against plain: equal greedy streams, each emitted token's logits row
    within LOGITS_RTOL.  Each run launches exactly its path's kernels
    (`DENSE_PATH`, `DENSE_F32`); the bf16 run's one FMA launch a
    step-function call is its f32 logits head."""
    import torch
    label = label or arch
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cfg, params = _model(arch, "bfloat16", num_layers)
    runs["bf16_params_gb"] = (torch.cuda.memory_allocated() - before) / 1e9
    prompts = dense_prompts(cfg.vocab_size)
    dense_serve(cfg, params, dense_prompts(cfg.vocab_size, 1), mode="auto")
    streams, runs["bf16"] = dense_serve(cfg, params, prompts, mode="auto")
    check_path_launches(f"{label} (bf16)", runs["bf16"]["launches"],
                        DENSE_PATH)
    calls = sum(runs["bf16"]["calls"].values())
    check(runs["bf16"]["launches"]["gpp_matmul"] == calls,
          f"{label}: {runs['bf16']['launches']['gpp_matmul']} FMA launches "
          f"for {calls} heads")
    again, prof = dense_serve(cfg, params, prompts, mode="auto",
                              profile=True)
    check(again == streams, f"{label}: the profiled run's streams differ")
    runs["bf16"]["device_busy_s"] = prof["device_busy_s"]
    runs["bf16"]["device_busy_share"] = check_busy(
        f"{label} bf16", prof["device_busy_s"], DENSE_PATH,
        runs["bf16"]["seconds"])
    plain, runs["bf16_ref"] = dense_serve(cfg, params, prompts, mode="ref")
    check(not any(runs["bf16_ref"]["launches"].values()),
          "the plain run launched a kernel")
    runs["bf16_tokens_equal_plain"] = sum(
        a == b for s, t in zip(streams, plain) for a, b in zip(s, t))
    runs["bf16"]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"{label} bf16: {runs['bf16_tokens_equal_plain']} of "
          f"{len(prompts) * 16} tokens equal to the plain bf16 run's; "
          f"{cfg.num_layers} layers, {runs['bf16_params_gb']:.1f} GB of "
          f"weights, peak {runs['bf16']['peak_mem_gb']:.1f} GB", flush=True)
    del params
    torch.cuda.empty_cache()
    cfg, params = _model(arch, "float32", num_layers)
    ker, runs["f32_kernel"] = dense_serve(cfg, params, prompts, mode="auto",
                                          keep_logits=True)
    ref, runs["f32_ref"] = dense_serve(cfg, params, prompts, mode="ref",
                                       keep_logits=True)
    check(not any(runs["f32_ref"]["launches"].values()),
          "the plain run launched a kernel")
    check_path_launches(f"{label} (f32)", runs["f32_kernel"]["launches"],
                        DENSE_F32)
    check(ker == ref, f"{label} f32 greedy streams differ: kernel {ker} "
                      f"plain {ref}")
    runs["f32_logits"] = check_logits(f"{label} f32", runs["f32_kernel"],
                                      runs["f32_ref"])
    runs["f32_logits"]["distinct"] = [len(set(t)) for t in ker]
    print(f"{label} f32 greedy streams kernel == plain: True "
          f"({cfg.num_layers} layers)", flush=True)
    del params
    torch.cuda.empty_cache()
    report.setdefault("serving", {})[label] = runs
    return runs


def step_inputs(cfg, dtype):
    """The step runs' inputs from seed 0: the prompt (tokens, or frame
    embeddings), the patch embeddings `enc` (cross layers), and the frame
    embedding of each decode step (musicgen)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(0)
    dt = getattr(torch, dtype)
    if cfg.input_mode == "tokens":
        x = torch.randint(0, cfg.vocab_size, (STEP_B, STEP_S), generator=g,
                          device="cuda", dtype=torch.int32)
        nxt = None
    else:
        x = torch.randn(STEP_B, STEP_S, cfg.d_model, generator=g,
                        device="cuda").to(dt)
        nxt = [torch.randn(STEP_B, 1, cfg.d_model, generator=g,
                           device="cuda").to(dt) for _ in range(STEP_NEW)]
    enc = (torch.randn(STEP_B, cfg.encoder_tokens, cfg.d_model, generator=g,
                       device="cuda").to(dt) if cfg.encoder_tokens else None)
    return x, enc, nxt


def step_run(cfg, params, inputs, *, mode: str, profile=False):
    """`transformer.prefill` then STEP_NEW `decode_step` calls (max_len
    STEP_S + STEP_NEW).  A token model takes its greedy token back; an
    embedding model takes the seeded frame embedding of the step.  Returns
    (greedy tokens (B, 1 + STEP_NEW), info with each row's f32 logits)."""
    import numpy as np
    import torch
    from repro_torch.models import transformer as tf
    x, enc, nxt = inputs
    c = cfg.with_(dense_kernel=mode)
    batch = {"tokens" if cfg.input_mode == "tokens" else "embeds": x}
    if enc is not None:
        batch["enc"] = enc
    torch.cuda.synchronize()
    for k in counters().values():
        k.n = 0

    def run():
        t0 = time.perf_counter()
        logits, caches = tf.prefill(params, c, batch,
                                    max_len=STEP_S + STEP_NEW)
        out = [logits[:, -1].float().cpu().numpy()]
        for t in range(STEP_NEW):
            tok = logits[:, -1].argmax(-1, keepdim=True).int()
            inp = tok if nxt is None else nxt[t]
            logits, caches = tf.decode_step(params, c, inp, caches,
                                            STEP_S + t, enc=enc)
            out.append(logits[:, -1].float().cpu().numpy())
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    (rows, dt), busy = _profiled(run, profile)
    counts = {k: v.n for k, v in counters().items()}
    rows = np.stack(rows, axis=1)                      # (B, 1 + NEW, V)
    check(bool(np.isfinite(rows).all()), f"{cfg.name}: non-finite logits")
    toks = rows.argmax(-1)
    info = {"model": cfg.name, "num_layers": cfg.num_layers,
            "dtype": cfg.dtype, "mode": mode, "engine": "steps",
            "tokens": int(toks.size), "seconds": dt,
            "tok_s": toks.size / dt, "calls": 1 + STEP_NEW,
            "launches": counts, "logits": list(rows)}
    if busy is not None:
        info["device_busy_s"] = busy
    print(f"steps {cfg.name} ({cfg.num_layers} layers) {cfg.dtype} "
          f"mode={mode}: prefill {STEP_B}x{STEP_S} + {STEP_NEW} decode "
          f"steps in {dt:.3f}s, launches {counts}", flush=True)
    return toks, info


def check_step_model(report, arch: str, f32_layers=None):
    """llama-3.2-vision-11b / musicgen-large through prefill + decode_step
    at full width: bf16 at full depth with the kernels (profiled: device
    time by kernel, busy share) and plain, then f32 (at `f32_layers` if
    set) with the kernels against plain: the same greedy tokens at every
    step and each logits row within LOGITS_RTOL."""
    import torch
    runs = {}
    torch.cuda.reset_peak_memory_stats()
    cfg, params = _model(arch, "bfloat16")
    from repro_torch.models import transformer as tf
    params = tf.serving_params(params, cfg)
    inputs = step_inputs(cfg, "bfloat16")
    step_run(cfg, params, inputs, mode="auto")             # warm-up
    toks, runs["bf16"] = step_run(cfg, params, inputs, mode="auto")
    runs["bf16"].pop("logits")
    again, prof = step_run(cfg, params, inputs, mode="auto", profile=True)
    check(bool((again == toks).all()),
          f"{arch}: the profiled run's tokens differ")
    runs["bf16"]["device_busy_s"] = prof["device_busy_s"]
    check_path_launches(f"{arch} steps (bf16)", runs["bf16"]["launches"],
                        DENSE_PATH)
    check(runs["bf16"]["launches"]["gpp_matmul"] == 1 + STEP_NEW,
          f"{arch}: {runs['bf16']['launches']['gpp_matmul']} FMA launches "
          f"for {1 + STEP_NEW} heads")
    runs["bf16"]["device_busy_share"] = check_busy(
        f"{arch} bf16 steps", runs["bf16"]["device_busy_s"], DENSE_PATH,
        runs["bf16"]["seconds"])
    plain, runs["bf16_ref"] = step_run(cfg, params, inputs, mode="ref")
    runs["bf16_ref"].pop("logits")
    check(not any(runs["bf16_ref"]["launches"].values()),
          "the plain run launched a kernel")
    runs["bf16_tokens_equal_plain"] = int((toks == plain).sum())
    runs["bf16"]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"{arch} bf16: {runs['bf16_tokens_equal_plain']} of {toks.size} "
          f"greedy tokens equal to the plain bf16 run's; {cfg.num_layers} "
          f"layers, peak {runs['bf16']['peak_mem_gb']:.1f} GB", flush=True)
    del params, inputs
    torch.cuda.empty_cache()
    cfg, params = _model(arch, "float32", f32_layers)
    params = tf.serving_params(params, cfg)
    inputs = step_inputs(cfg, "float32")
    ker, runs["f32_kernel"] = step_run(cfg, params, inputs, mode="auto")
    ref, runs["f32_ref"] = step_run(cfg, params, inputs, mode="ref")
    check_path_launches(f"{arch} steps (f32)",
                        runs["f32_kernel"]["launches"], DENSE_F32)
    check(bool((ker == ref).all()),
          f"{arch} f32 greedy tokens differ: kernel {ker} plain {ref}")
    runs["f32_logits"] = check_logits(f"{arch} f32", runs["f32_kernel"],
                                      runs["f32_ref"])
    print(f"{arch} f32 greedy tokens kernel == plain: True "
          f"({cfg.num_layers} layers)", flush=True)
    del params, inputs
    torch.cuda.empty_cache()
    report.setdefault("serving", {})[arch] = runs
    return runs


# ---------------------------------------------------------------------------
# slice 14: training (loss, remat, AdamW / Adafactor, data, checkpoints)
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 4, 1024      # qwen: two 512-token cross-entropy chunks
DS_TRAIN_S, DS_TRAIN_LAYERS = 512, 2   # deepseek: the dense layer + 1 MoE
TRAIN_PATH = ("gpp_matmul_tc", "gpp_matmul", "rmsnorm")
TRAIN_MOE = TRAIN_PATH + ("gpp_matmul_grouped_tc",)
TRAIN_F32 = ("gpp_matmul", "rmsnorm")
TRAIN_STEPS, TRAIN_LR = 8, 1e-3   # tests/test_system.py's micro-train
# bf16: the loss's relative error, a leaf's gradient cosine (sound runs
# read >= 0.99991), a null leaf's share of the global norm
BF16_LOSS_RTOL, GRAD_COS, GRAD_NULL = 1e-3, 0.999, 1e-3
F32_LOSS_RTOL, F32_GRAD_RTOL = 1e-5, 1e-3
# product kernels PyTorch's matmuls launch (cuBLAS / CUTLASS): the kernels'
# backward products (inside `kernels.ops.BACKWARD_RANGE`) and, outside it,
# the plain attention's einsums (forward, remat and backward)
LIBRARY_PRODUCTS = ("gemm", "Gemm", "xmma", "cutlass", "sm90_")


def train_batch(cfg, B: int, S: int, step: int = 0):
    """Batch `step` of the ported `TokenPipeline` (seed 0), on the card."""
    import torch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    pipe = TokenPipeline(cfg, DataConfig(seed=0, batch=B, seq_len=S))
    return {k: torch.from_numpy(v).cuda()
            for k, v in pipe.batch_at(step).items()}


def named_leaves(tree) -> dict:
    from repro_torch.checkpoint.manager import _flatten_with_names
    return _flatten_with_names(tree)


def counted(fn, *a):
    """fn(*a) with every launch count set to 0 just before; returns (out,
    counts)."""
    import torch
    torch.cuda.synchronize()
    for c in counters().values():
        c.n = 0
    out = fn(*a)
    torch.cuda.synchronize()
    return out, {k: c.n for k, c in counters().items()}


def grad_routes(what: str, cfg, params, batch, path):
    """One loss and gradient on the kernel route (the path's kernels,
    recomputation included, and no others) and on the plain route
    (`dense_kernel="ref"`: none of the port's kernels), on the card.
    Returns (kernel (loss, grads), plain (loss, grads), kernel counts)."""
    from repro_torch.launch.steps import value_and_grad
    ker, counts = counted(value_and_grad, cfg, params, batch)
    check_path_launches(f"{what} kernel route", counts, path)
    plain, pcounts = counted(value_and_grad, cfg.with_(dense_kernel="ref"),
                             params, batch)
    check(not any(pcounts.values()),
          f"{what}: the plain route launched {pcounts}")
    for name, g in named_leaves(ker[1]).items():
        check(bool(g.float().isfinite().all()),
              f"{what}: a non-finite gradient at {name}")
    print(f"{what}: launches on the kernel route (fwd, remat, bwd) "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return ker, plain, counts


def compare_bf16_grads(what: str, ker, plain) -> dict:
    """bf16: the loss within BF16_LOSS_RTOL; each leaf's gradient at cosine
    >= GRAD_COS with the plain one, but for a leaf whose exact gradient is
    0, where a cosine means nothing: both its norms under GRAD_NULL of the
    global norm.  Those are the leaves whose plain gradient is exactly 0:
    deepseek's unstacked layer 0 inits its 1-D `kv_norm` to zeros, as the
    reference does, so its attention's values are 0 and every attention
    leaf but `kv_norm` gets no gradient.  (The k bias, whose gradient is
    small, is held to the cosine.)  Every leaf's cosine and share of the
    global norm are kept."""
    import torch
    (lk, gk), (lp, gp) = ker, plain
    rel = abs(float(lk) - float(lp)) / abs(float(lp))
    gk, gp = named_leaves(gk), named_leaves(gp)
    total = math.sqrt(sum(float(g.float().square().sum())
                          for g in gp.values()))
    leaves, null = {}, []
    for name, a in gk.items():
        a, b = a.float().flatten(), gp[name].float().flatten()
        na, nb = float(a.norm()), float(b.norm())
        leaves[name] = {"cosine": float(torch.dot(a, b)) / max(na * nb,
                                                               1e-30),
                        "norm_share": nb / total,
                        "kernel_norm_share": na / total}
        if nb == 0.0:
            null.append(name)
    ranked = sorted((v["cosine"], n) for n, v in leaves.items()
                    if n not in null)
    shares = {n: (leaves[n]["kernel_norm_share"], leaves[n]["norm_share"])
              for n in null}
    print(f"{what} bf16: loss {float(lk):.6f} vs plain {float(lp):.6f} "
          f"({rel:.3g}); least gradient cosines "
          f"{[(round(c, 6), n) for c, n in ranked[:4]]}; null leaves' "
          f"norms / the global norm (kernel, plain) {shares}", flush=True)
    check(rel <= BF16_LOSS_RTOL, f"{what}: bf16 loss {float(lk)} vs plain "
                       f"{float(lp)} ({rel:.3g} relative)")
    for n in null:
        check(max(leaves[n]["norm_share"], leaves[n]["kernel_norm_share"])
              < GRAD_NULL, f"{what}: {n}'s gradient norms {leaves[n]}")
    check(ranked[0][0] >= GRAD_COS, f"{what}: bf16 gradient of "
                                    f"{ranked[0][1]} at cosine "
                                    f"{ranked[0][0]:.5f} with the plain one")
    return {"loss": float(lk), "plain_loss": float(lp), "loss_rel": rel,
            "least_cosine": ranked[0][0], "least_cosine_leaf": ranked[0][1],
            "null_leaves": null, "global_norm": total, "leaves": leaves}


def compare_f32_grads(what: str, ker, plain) -> dict:
    """f32: the loss within F32_LOSS_RTOL relative; each leaf within
    F32_GRAD_RTOL x max(its largest |plain| value, 1e-3 x the largest over
    all leaves)."""
    (lk, gk), (lp, gp) = ker, plain
    rel = abs(float(lk) - float(lp)) / abs(float(lp))
    check(rel <= F32_LOSS_RTOL, f"{what}: f32 loss {float(lk)} vs plain "
                                f"{float(lp)} ({rel:.3g} relative)")
    gk, gp = named_leaves(gk), named_leaves(gp)
    top = max(float(g.abs().max()) for g in gp.values())
    worst = (-1.0, "")
    for name, a in gk.items():
        b = gp[name]
        err = float((a - b).abs().max()) / max(float(b.abs().max()),
                                               1e-3 * top)
        worst = max(worst, (err, name))
    check(worst[0] <= F32_GRAD_RTOL, f"{what}: f32 gradient of {worst[1]} "
                                     f"off by {worst[0]:.3g} of its scale")
    print(f"{what} f32: loss {float(lk):.8f} vs plain {float(lp):.8f} "
          f"({rel:.3g}); worst leaf {worst[1]} at {worst[0]:.3g} of its "
          f"scale (gate {F32_GRAD_RTOL})", flush=True)
    return {"loss": float(lk), "plain_loss": float(lp), "loss_rel": rel,
            "worst_leaf_rel": worst[0], "worst_leaf": worst[1]}


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (-0.0 is not 0.0)."""
    import torch
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return (a.dtype == b.dtype and a.shape == b.shape and bool(torch.equal(
        a.view(ints[a.element_size()]), b.view(ints[b.element_size()]))))


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in named_leaves(tree).values())


def profiled_split(fn) -> "tuple[object, dict, float]":
    """fn() under torch.profiler: (its result, device seconds under
    gpp_matmul tc / FMA, rmsnorm, the kernels' backward (its library
    products and the rest, by the kernels launched from inside
    `kernels.ops.BACKWARD_RANGE`), the library's other products (the plain
    attention's einsums) and everything else, the wall seconds)."""
    import torch
    from torch.profiler import ProfilerActivity
    from repro_torch.kernels.ops import BACKWARD_RANGE
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    split = dict.fromkeys(("gpp_matmul_tc", "gpp_matmul",
                           "gpp_matmul_grouped_tc", "rmsnorm",
                           "backward_products", "backward_other",
                           "library_products", "other"), 0.0)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    for e in events:
        # a range recorded on the CPU also shows on the device's timeline
        # (a user annotation spanning its kernels): not a kernel
        if e.device_type != cuda or e.name == BACKWARD_RANGE or getattr(
                e, "is_user_annotation", False):
            continue
        key = next((k for k in split if k in KERNEL_NAMES
                    and KERNEL_NAMES[k] in e.name), None)
        if key is None:
            key = ("library_products" if any(n in e.name for n in
                                             LIBRARY_PRODUCTS) else "other")
        split[key] += e.time_range.elapsed_us() / 1e6
    # the device kernels that the CPU ops under the backward ranges
    # launched (each op keeps its own in `kernels`) move to their own keys
    seen, stack = set(), [e for e in events if e.device_type != cuda
                          and e.name == BACKWARD_RANGE]
    while stack:
        e = stack.pop()
        if id(e) in seen:
            continue
        seen.add(id(e))
        stack.extend(e.cpu_children)
        for k in e.kernels:
            if any(name in k.name for name in KERNEL_NAMES.values()):
                continue
            product = any(n in k.name for n in LIBRARY_PRODUCTS)
            split["backward_products" if product else "backward_other"] += \
                k.duration / 1e6
            split["library_products" if product else "other"] -= \
                k.duration / 1e6
    check(min(split.values()) > -1e-6, f"the profiled split counts a "
                                       f"kernel twice: {split}")
    return out, split, wall


def check_train_qwen(report):
    """qwen1.5-0.5b at full width and depth (24 layers), AdamW, batch 4 x
    1024 (two cross-entropy chunks), block remat: (1) one loss and
    gradient on the kernel route against the plain route in bf16 and in
    f32 (launches of the path's kernels only, and none on the plain
    route); (2) 8 AdamW steps at a constant 1e-3, the last loss below the
    first; (3) an async checkpoint after step 8, restored into a fresh
    tree bit for bit, one step from each with equal losses; (4) the CLI
    (`--smoke`), 4 steps with a checkpoint every 2, then resumed to 6;
    (5) one Adafactor step; (6) tok/s over the timed steps, peak memory,
    and one profiled step's device time by part and busy share."""
    import contextlib
    import io
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adafactor as adaf
    from repro_torch.optim import adamw
    arch = "qwen1.5-0.5b"
    out, seconds = {}, {}
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = _model(arch, "bfloat16")
    batch = train_batch(cfg, TRAIN_B, TRAIN_S)
    value_and_grad(cfg, params, batch)                     # warm-up
    ker, plain, counts = grad_routes(f"train {arch}", cfg, params, batch,
                                     TRAIN_PATH)
    out["bf16"] = compare_bf16_grads(f"train {arch}", ker, plain)
    out["bf16"].update(launches=counts, num_layers=cfg.num_layers)
    del ker, plain
    seconds["routes bf16"] = time.perf_counter() - t

    t = time.perf_counter()
    optc = adamw.AdamWConfig(lr=TRAIN_LR)
    state = adamw.adamw_init(params)
    losses, step_s = [], []
    p, o = params, state
    for i in range(TRAIN_STEPS):
        b = train_batch(cfg, TRAIN_B, TRAIN_S, i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, g = value_and_grad(cfg, p, b)
        p, o, _ = adamw.adamw_update(optc, g, o, p)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t1)
        del g
    check(all(map(math.isfinite, losses)), f"train {arch}: losses {losses}")
    check(losses[-1] < losses[0], f"train {arch}: no descent {losses}")
    timed = step_s[1:]
    out["descent"] = {"losses": losses, "step_s": step_s,
                      "tok_s": TRAIN_B * TRAIN_S * len(timed) / sum(timed)}
    print(f"train {arch} AdamW lr {TRAIN_LR}: losses "
          f"{[round(x, 4) for x in losses]}; {out['descent']['tok_s']:.0f} "
          f"tok/s over steps 2-{TRAIN_STEPS}", flush=True)
    seconds["descent"] = time.perf_counter() - t

    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(TRAIN_STEPS, {"p": p, "o": o}, blocking=False)
        mgr.wait()
        fresh = {"p": tf.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")}
        fresh["o"] = adamw.adamw_init(fresh["p"])
        restored, at = mgr.restore(fresh)
        del fresh
    check(at == TRAIN_STEPS, f"restored step {at}")
    live = named_leaves({"p": p, "o": o})
    for name, r in named_leaves(restored).items():
        check(same_bits(r, live[name]),
              f"train {arch}: checkpoint leaf {name} differs")
    b = train_batch(cfg, TRAIN_B, TRAIN_S, TRAIN_STEPS)
    l_restored = float(value_and_grad(cfg, restored["p"], b)[0])
    l_live = float(value_and_grad(cfg, p, b)[0])
    check(l_restored == l_live, f"train {arch}: the restored state's loss "
                                f"{l_restored} != the live one's {l_live}")
    out["checkpoint"] = {"leaves": len(live), "bytes": tree_bytes(restored),
                         "loss": l_live}
    print(f"train {arch} checkpoint: {len(live)} leaves "
          f"({out['checkpoint']['bytes'] / 1e9:.2f} GB) restored bit for "
          f"bit; a step from each: loss {l_restored} == {l_live}",
          flush=True)
    del restored
    seconds["checkpoint"] = time.perf_counter() - t

    t = time.perf_counter()
    step = make_train_step(cfg.with_(optimizer="adafactor"), optc=optc)
    fs = adaf.adafactor_init(params)
    _, fs2, m = step.fn(params, fs, b, 0)
    ada = float(m["loss"])
    check(math.isfinite(ada), f"train {arch}: Adafactor loss {ada}")
    out["adafactor"] = {"loss": ada, "state_bytes": tree_bytes(fs2),
                        "adamw_state_bytes": tree_bytes(o)}
    print(f"train {arch} Adafactor step: loss {ada:.4f}; state "
          f"{out['adafactor']['state_bytes'] / 1e6:.1f} MB against AdamW's "
          f"{out['adafactor']['adamw_state_bytes'] / 1e6:.1f} MB",
          flush=True)
    del fs, fs2
    seconds["adafactor"] = time.perf_counter() - t

    # the device time of one profiled step (loss, gradient, AdamW) over
    # the wall time of an unprofiled one (the timed steps' mean)
    t = time.perf_counter()
    _, split, wall = profiled_split(lambda: adamw.adamw_update(
        optc, value_and_grad(cfg, p, b)[1], o, p))
    busy = sum(split.values())
    step_wall = sum(timed) / len(timed)
    check(split["backward_products"] > 0, f"train {arch}: no device time "
          f"inside the kernels' backward ranges {split}")
    out["profile"] = {"device_s": split, "busy_share": busy / step_wall,
                      "step_wall_s": step_wall, "profiled_wall_s": wall,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"train {arch} profiled step: device "
          f"{ {k: round(v, 4) for k, v in split.items()} } s, busy "
          f"{busy / step_wall:.3f} of a {step_wall:.3f}s step ("
          f"{wall:.3f}s profiled); peak {out['profile']['peak_mem_gb']:.1f} "
          f"GB", flush=True)
    del p, o, params, state
    torch.cuda.empty_cache()
    seconds["profile"] = time.perf_counter() - t

    # the CLI at SMOKE widths: its checkpoints of the full model's AdamW
    # state would be 4.6 GB each (the full width ran above)
    t = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        logs = []
        for steps in (4, 6):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli = train_cli.main(["--arch", arch, "--smoke", "--steps",
                                      str(steps), "--ckpt-every", "2",
                                      "--ckpt-dir", d])
            logs.append(buf.getvalue())
            check(all(map(math.isfinite, cli)), f"CLI losses {cli}")
            out.setdefault("cli_losses", []).append(cli)
    check("resumed from step" not in logs[0], "the first CLI call resumed")
    check("resumed from step 4" in logs[1],
          f"the second CLI call did not resume from step 4: {logs[1]}")
    first, second = ([round(x, 4) for x in c] for c in out["cli_losses"])
    print(f"train {arch} CLI: --steps 4 --ckpt-every 2 losses {first}, "
          f"then --steps 6 resumed from step 4: {second}", flush=True)
    seconds["cli"] = time.perf_counter() - t

    t = time.perf_counter()
    cfg, params = _model(arch, "float32")
    batch = train_batch(cfg, TRAIN_B, TRAIN_S)
    ker, plain, counts = grad_routes(f"train {arch} f32", cfg, params,
                                     batch, TRAIN_F32)
    out["f32_kernel"] = compare_f32_grads(f"train {arch}", ker, plain)
    out["f32_kernel"].update(launches=counts, num_layers=cfg.num_layers)
    del ker, plain, params
    torch.cuda.empty_cache()
    seconds["routes f32"] = time.perf_counter() - t
    out["seconds"] = seconds
    print(f"train {arch} seconds: "
          f"{ {k: round(v, 1) for k, v in seconds.items()} }", flush=True)
    report.setdefault("serving", {})[f"train {arch}"] = out
    return out


def check_train_deepseek(report):
    """deepseek-v2-lite-16b at full width with 2 layers (the dense layer 0
    and one MoE layer), bf16, batch 4 x 512: the kernel route against the
    plain one (the router and every expert stack among the leaves), the
    grouped tensor-core kernel launched at the training capacity, the aux
    load-balance loss on both routes (f32 router, on the final hidden
    states), one AdamW step."""
    import dataclasses
    import torch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    arch = "deepseek-v2-lite-16b"
    out, t = {}, time.perf_counter()
    cfg, params = _model(arch, "bfloat16", DS_TRAIN_LAYERS)
    batch = train_batch(cfg, TRAIN_B, DS_TRAIN_S)
    mc = tf._moe_cfg(cfg)
    T = TRAIN_B * DS_TRAIN_S
    G = moe_mod._dispatch_groups(mc, T)
    rows = G * moe_mod.capacity(mc, T // G)
    from repro_torch.kernels import gpp_matmul as gm
    shapes = []
    launch = gm._launch_grouped

    def seen(x, *a, **kw):
        shapes.append(tuple(x.shape))
        return launch(x, *a, **kw)
    gm._launch_grouped = seen
    try:
        ker, plain, counts = grad_routes(f"train {arch}", cfg, params,
                                         batch, TRAIN_MOE)
    finally:
        gm._launch_grouped = launch
    check(bool(shapes) and all(s[:2] == (cfg.num_experts, rows)
                               for s in shapes),
          f"train {arch}: grouped launches at {set(shapes)}, not "
          f"({cfg.num_experts}, {rows}, ...)")
    out["bf16"] = compare_bf16_grads(f"train {arch}", ker, plain)
    out["bf16"].update(launches=counts, num_layers=DS_TRAIN_LAYERS,
                       grouped_shapes=sorted(set(shapes)))
    del ker, plain
    with torch.no_grad():
        h = tf.hidden_states(params, cfg, batch)
        p0 = tf._index(params["blocks"]["b0"]["moe"], 0)
        aux_k = float(moe_mod.aux_load_balance_loss(p0, mc, h))
        aux_p = float(moe_mod.aux_load_balance_loss(
            p0, dataclasses.replace(mc, dense_kernel="ref"), h))
    check(abs(aux_k - aux_p) <= 1e-5, f"train {arch}: aux loss {aux_k} vs "
                                      f"plain {aux_p}")
    out["aux_loss"] = {"kernel": aux_k, "plain": aux_p}
    step = make_train_step(cfg, optc=adamw.AdamWConfig(lr=TRAIN_LR))
    state = adamw.adamw_init(params)
    _, _, m = step.fn(params, state, batch, 0)
    check(math.isfinite(float(m["loss"])), f"train {arch}: AdamW loss")
    out["adamw_loss"] = float(m["loss"])
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["seconds"] = time.perf_counter() - t
    print(f"train {arch} ({DS_TRAIN_LAYERS} layers): grouped launches at "
          f"{sorted(set(shapes))}; aux loss {aux_k:.8f} vs plain "
          f"{aux_p:.8f}; AdamW step loss {out['adamw_loss']:.4f}; peak "
          f"{out['peak_mem_gb']:.1f} GB", flush=True)
    del params, state
    torch.cuda.empty_cache()
    report.setdefault("serving", {})[f"train {arch}"] = out
    return out


TRAIN_GPP = {"qkv (bias)": (D, D, True), "gate_up": (D, F, False),
              "down": (F, D, False)}


def event_times(fns: dict, sets, iters: int) -> dict:
    """{key: ms a call} of each function over `sets`, by CUDA events
    (`time_ms`).  The training shapes' calls take 0.1-35 ms, so the
    host's launch cost is a few percent of them, and CUDA events do not
    drop a call as a profiler trace now and then does."""
    return {k: time_ms(fn, sets, iters) for k, fn in fns.items()}


def check_train_kernels(report):
    """The kernels at the training shapes, each first held element by
    element against its plain version on its own route (TOL; the head as
    `check_head` holds it; RMSNorm as `rms_err` does, at qwen's 4 x 1024
    and deepseek's 4 x 512 rows), then timed by CUDA events beside its
    plain version, the library's call and its bound: the tensor-core
    gpp_matmul at qwen's projections over 4 x 1024 rows, the FMA f32 head
    at one 512-position chunk (2048 x 1024 x 151936: f32 x against the
    bf16 table's (d, vocab) copy; the library multiplies the f32 table)
    and the grouped tensor-core kernel at deepseek's training capacity."""
    import torch
    from repro_torch.kernels import gpp_matmul as gm
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels.gpp_matmul import gpp_matmul, gpp_matmul_grouped
    from repro_torch.kernels.ref import (dense_grouped_ref, dense_ref,
                                         rmsnorm_ref)
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    rows = []
    g = torch.Generator(device="cuda").manual_seed(3)
    M = TRAIN_B * TRAIN_S
    for proj, (K, N, bias) in TRAIN_GPP.items():
        err = gpp_case(M, K, N, "bfloat16", bias=bias, seed=3)
        sets = [(torch.randn(M, K, generator=g, device="cuda").bfloat16(),
                 (torch.randn(K, N, generator=g, device="cuda")
                  * 0.02).bfloat16(),
                 (torch.randn(N, generator=g, device="cuda")
                  * 0.1).bfloat16() if bias else None)
                for _ in range(copies_for(K * N * 2))]
        rows.append({"kernel": "gpp_matmul_tc", "proj": proj, "M": M,
                     "K": K, "N": N, "max_abs_err": err, **event_times({
                         "ms": lambda x, w, b: gpp_matmul(x, w, bias=b),
                         "plain_ms": lambda x, w, b: dense_ref(x, w, bias=b),
                         "library_ms": lambda x, w, b: torch.matmul(x, w)
                         if b is None else torch.addmm(b, x, w)}, sets, 50)})
        rows[-1]["bound_ms"], rows[-1]["bound_by"] = bound(
            (M * K + K * N + M * N + (N if bias else 0)) * 2,
            2.0 * M * K * N, "bfloat16")
        del sets
    hm, V = TRAIN_B * 512, 151936
    table = (torch.randn(V, D, generator=g, device="cuda") * 0.02).bfloat16()
    sets = [(torch.randn(hm, D, generator=g, device="cuda"),
             table.t().contiguous(), table.float())]
    fma = gm.launches.n
    y = ops.dense(*sets[0][:2])
    check(gm.launches.n == fma + 1, "train head: not the FMA route")
    ref = dense_ref(*sets[0][:2])
    d = (y - ref).abs()
    err = float(d.max())
    check(bool(torch.isfinite(y).all())
          and bool((d <= 2e-4 + 2e-4 * ref.abs()).all()),
          f"train head {hm}x{D}x{V}: max err {err}")
    del y, ref, d
    rows.append({"kernel": "gpp_matmul", "proj": "f32 head", "M": hm,
                 "K": D, "N": V, "max_abs_err": err, **event_times({
                     "ms": lambda x, wt, _: ops.dense(x, wt),
                     "plain_ms": lambda x, wt, _: dense_ref(x, wt),
                     "library_ms": lambda x, _, t32: x @ t32.t()}, sets, 10)})
    rows[-1]["bound_ms"], rows[-1]["bound_by"] = bound(
        hm * D * 4 + D * V * 2 + hm * V * 4, 2.0 * hm * D * V, "float32")
    del sets, table
    torch.cuda.empty_cache()
    cfg = registry.get_config("deepseek-v2-lite-16b")
    mc = tf._moe_cfg(cfg)
    T = TRAIN_B * DS_TRAIN_S
    G = moe_mod._dispatch_groups(mc, T)
    cap = G * moe_mod.capacity(mc, T // G)
    for proj, (K, N) in DS_PROJ.items():
        sets = [grouped_inputs(cap, K, N, "bfloat16", seed=i)
                for i in range(copies_for(DS_E * K * N * 2))]
        err = grouped_check(*sets[0], what="training capacity")
        rows.append({"kernel": "gpp_matmul_grouped_tc", "proj": proj,
                     "E": DS_E, "M": cap, "K": K, "N": N,
                     "max_abs_err": err, **event_times({
                         "ms": lambda x, w: gpp_matmul_grouped(x, w),
                         "plain_ms": lambda x, w: dense_grouped_ref(x, w),
                         "library_ms": torch.bmm}, sets, 50)})
        rows[-1]["bound_ms"], rows[-1]["bound_by"] = bound(
            DS_E * (cap * K + K * N + cap * N) * 2,
            2.0 * DS_E * cap * K * N, "bfloat16")
        del sets
    norms = {}
    for arch, (n, width) in {"qwen1.5-0.5b": (M, D),
                             "deepseek-v2-lite-16b": (T, DS_D)}.items():
        x = (torch.randn(n, width, generator=g, device="cuda")
             * 2).bfloat16()
        scale = (1 + 0.1 * torch.randn(width, generator=g,
                                       device="cuda")).bfloat16()
        before = rn.launches_rmsnorm.n
        y = rn.rmsnorm(x, scale, RMS_EPS)
        check(rn.launches_rmsnorm.n == before + 1, "rmsnorm did not launch")
        err, ok = rms_err(y, rmsnorm_ref(x, scale, RMS_EPS), "bfloat16")
        check(ok and bool(torch.isfinite(y.float()).all()),
              f"train rmsnorm {arch} {n}x{width}: max err {err}")
        norms[f"{arch} {n}x{width}"] = err
    for r in rows:
        shape = "x".join(str(r[k]) for k in ("E", "M", "K", "N") if k in r)
        print(f"train shape {r['kernel']} {r['proj']} {shape}: max_abs_err="
              f"{r['max_abs_err']:.3g} ms={r['ms']:.4f} plain_ms="
              f"{r['plain_ms']:.4f} library_ms={r['library_ms']:.4f} "
              f"({r['ms'] / r['library_ms']:.2f}x) bound_ms="
              f"{r['bound_ms']:.4f} ({r['bound_by']})", flush=True)
    print(f"train shape rmsnorm bf16 max_abs_err {norms}", flush=True)
    report["train_kernels"] = rows
    report["train_rmsnorm_max_abs_err"] = norms
    return rows, norms


# slice 15: the layer streamer (core.streamer) at qwen1.5-0.5b's full width
# and depth, its 24 layers resting in pinned host memory
STREAM_SHAPES = ((4, 1024), (4, 16))   # training's tokens; a copy-bound pass
STREAM_RINGS = (2, 3, 4)
STREAM_WARM, STREAM_TIMED = 2, 5
STREAM_GRAD_RING = 3
STREAM_PATH = ("gpp_matmul_tc", "gpp_matmul", "rmsnorm")


def event_ms(fn, warm: int, timed: int) -> "tuple[float, list, float]":
    """(median, all) ms of `timed` calls of fn by CUDA events, each its own
    pair of events, after `warm` calls; and the median ms the host took to
    issue a call (from its start to its return, before the card
    finishes)."""
    import statistics
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(timed):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        fn()
        b.record()
        host.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times), times, statistics.median(host)


def h2d_rate(nbytes: int) -> "tuple[float, float]":
    """(bytes / s, ms) of one contiguous pinned host buffer of `nbytes`
    copied to the card, median of 10."""
    import torch
    src = torch.ones(nbytes, dtype=torch.uint8).pin_memory()
    dst = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    ms, _, _ = event_ms(lambda: dst.copy_(src, non_blocking=True), 2, 10)
    check(bool(dst.eq(1).all()), "host-to-device copy")
    return nbytes / (ms * 1e-3), ms


def layer_flops(cfg, B: int, S: int) -> float:
    """One layer's operations on B x S tokens: 2 a weight of its
    projections a token, and the plain attention's two products over
    every score (it computes the masked ones too)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import map_specs, tree_leaves
    sizes = map_specs(lambda _, s: math.prod(s.shape) if len(s.shape) > 1
                      else 0, tf.block_specs(cfg, cfg.pattern[0]))
    width = cfg.num_heads * cfg.resolved_head_dim
    return 2.0 * B * S * sum(tree_leaves(sizes)) + 4.0 * B * S * S * width


def recording(rec: list):
    """Every `stream_layers` call of the transformer appends its issue
    record to `rec` until the returned undo is called."""
    from repro_torch.models import transformer as tf
    inner = tf.stream_layers

    def recorded(*a, **kw):
        return inner(*a, record=rec, **kw)
    tf.stream_layers = recorded
    return lambda: setattr(tf, "stream_layers", inner)


def step_bytes(rec: list) -> dict:
    out = {}
    for step, _, _, nbytes in rec:
        out[step] = out.get(step, 0) + nbytes
    return out


def check_layer_streaming(report):
    """qwen1.5-0.5b at full width and all 24 layers, bf16, random weights
    from seed 0; `params["blocks"]` (the 24 stacked layers) copied into
    pinned host memory, the embedding and the final norm on the card.  For
    4 x 1024 and 4 x 16 tokens: resident (every layer on the card, the
    yardstick), then insitu, naive_pp and gpp at G = 2, 3, 4 and the rings
    `plan_stream` plans at the bf16 peak and at the compute time resident
    measured a layer, each with `StreamSettings(chunk_dim=0)` (a chunk is a
    contiguous run of rows): the hidden states and logits equal resident's
    bit for bit, the tensor-core `gpp_matmul` and RMSNorm launched in each
    streamed pass (the FMA head too in the logits pass), the bytes each
    step issued flat at one layer after the prologue, the median of 5
    timed hidden-state passes by CUDA events after 2 warm-ups, and the
    peak HBM.  Also the host-to-device rate on one layer's contiguous
    pinned bytes, and the loss and every gradient leaf of a remat step at
    4 x 1024 under gpp (G = 3) against resident's (resident twice first:
    equal if resident repeats itself, else no further from it than it is
    from itself)."""
    import torch
    from repro_torch.core.schedule import plan_stream
    from repro_torch.core.streamer import StreamSettings
    from repro_torch.launch.steps import stream_specs, value_and_grad
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import tree_leaves, tree_map
    arch, card = "qwen1.5-0.5b", report["card"]
    out = report["layer_streaming"] = {"card": card}
    cfg, params = _model(arch, "bfloat16")
    check(cfg.num_layers == 24 and cfg.num_superblocks == 24,
          f"{arch}: {cfg.num_layers} layers")
    host = tree_map(lambda t: t.cpu().pin_memory(), params["blocks"])
    check(all(t.is_pinned() for t in tree_leaves(host)), "pinned blocks")
    streamed = {**params, "blocks": host}
    layer_params = sum(t[0].numel() for t in tree_leaves(host))
    layer_bytes = sum(t[0].numel() * t.element_size()
                      for t in tree_leaves(host))
    rate, copy_ms = h2d_rate(layer_bytes)
    out.update(layer_params=layer_params, layer_bytes=layer_bytes,
               blocks_bytes=layer_bytes * cfg.num_layers,
               h2d_bytes_per_s=rate, h2d_layer_ms=copy_ms)
    print(f"layer streaming [{card}]: {arch} {cfg.num_layers} layers, "
          f"{layer_params:,} parameters a layer ({layer_bytes / 1e6:.2f} "
          f"MB), {layer_bytes * cfg.num_layers / 1e6:.1f} MB of blocks in "
          f"pinned host memory; host-to-device {rate / 1e9:.2f} GB/s "
          f"({copy_ms:.4f} ms for one layer's contiguous pinned bytes)",
          flush=True)
    specs = stream_specs(cfg)

    def settings(mode, G=4):
        return cfg.with_(stream=StreamSettings(mode=mode, ring_depth=G,
                                               chunk_dim=0))

    # resident first, the blocks on the card: the yardstick's bits and times
    ref, shapes = {}, {}
    with torch.no_grad():
        for B, S in STREAM_SHAPES:
            fb = {"tokens": train_batch(cfg, B, S)["tokens"]}
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            ms, times, host_ms = event_ms(
                lambda: tf.hidden_states(params, cfg, fb), STREAM_WARM,
                STREAM_TIMED)
            peak = torch.cuda.max_memory_allocated()
            ref[B, S] = (tf.hidden_states(params, cfg, fb),
                         tf.forward(params, cfg, fb))
            shapes[f"{B}x{S}"] = {"resident": {
                "ms": ms, "times": times, "host_ms": host_ms,
                "base_gb": base / 1e9, "peak_gb": peak / 1e9}}
    # the gradient's yardstick, twice
    gb = train_batch(cfg, TRAIN_B, TRAIN_S)
    res = [value_and_grad(cfg, params, gb) for _ in range(2)]
    res = [(loss, {k: v.cpu() for k, v in named_leaves(g).items()})
           for loss, g in res]
    del params                       # the card keeps no layer from here on
    torch.cuda.empty_cache()

    launches = dict.fromkeys(STREAM_PATH, 0)
    for B, S in STREAM_SHAPES:
        key = f"{B}x{S}"
        row = shapes[key]
        fb = {"tokens": train_batch(cfg, B, S)["tokens"]}
        hid_ref, logits_ref = ref[B, S]
        flops = layer_flops(cfg, B, S)
        t_layer = row["resident"]["ms"] * 1e-3 / cfg.num_layers
        plans = {}
        for name, fps in (("peak 989e12", PEAK_OPS["bfloat16"]),
                          ("measured", flops / t_layer)):
            p = plan_stream(block_bytes=layer_bytes, compute_flops=flops,
                            flops_per_s=fps, transfer_bytes_per_s=rate,
                            max_ring=8)
            L = cfg.num_layers
            plans[name] = {
                "G": p.ring_depth, "chunks": p.chunks,
                "t_compute_ms": p.t_compute * 1e3,
                "t_transfer_ms": p.t_transfer * 1e3,
                "insitu_ms": L * (p.t_compute + p.t_transfer) * 1e3,
                "ping_pong_ms": (p.t_transfer
                                 + L * max(p.t_compute, p.t_transfer)) * 1e3}
            print(f"layer streaming {key} plan_stream at {name} "
                  f"({fps:.4g} FLOP/s, {flops / 1e9:.3f} GFLOP a layer; "
                  f"{rate / 1e9:.2f} GB/s): G={p.ring_depth} chunks="
                  f"{p.chunks} t_compute={p.t_compute * 1e3:.4f} ms "
                  f"t_transfer={p.t_transfer * 1e3:.4f} ms; predicted "
                  f"insitu {plans[name]['insitu_ms']:.3f} ms, ping-pong "
                  f"{plans[name]['ping_pong_ms']:.3f} ms [{card}]",
                  flush=True)
        row["plans"] = plans
        rings = sorted({*STREAM_RINGS, *(p["G"] for p in plans.values())})
        variants = [("insitu", 4), ("naive_pp", 4)] + [("gpp", g)
                                                       for g in rings]
        res_ms = row["resident"]["ms"]
        r = row["resident"]
        print(f"layer streaming {key} resident: {res_ms:.3f} ms a pass "
              f"(hidden states; {r['times']}; the host issued it in "
              f"{r['host_ms']:.3f} ms); peak "
              f"{r['peak_gb'] - r['base_gb']:.3f} GB above the "
              f"{r['base_gb']:.3f} GB held before the pass [{card}]",
              flush=True)
        for mode, G in variants:
            name = mode if mode != "gpp" else f"gpp G={G}"
            c = settings(mode, G)
            rec = []
            undo = recording(rec)
            try:
                with torch.no_grad():
                    hid, counts = counted(tf.hidden_states, streamed, c, fb,
                                          None, *specs)
                    logits, lcounts = counted(tf.forward, streamed, c, fb,
                                              None, *specs)
            finally:
                undo()
            check(same_bits(hid, hid_ref),
                  f"{key} {name}: hidden states differ from resident's")
            check(same_bits(logits, logits_ref),
                  f"{key} {name}: logits differ from resident's")
            check_path_launches(f"{key} {name} hidden states", counts,
                                ("gpp_matmul_tc", "rmsnorm"))
            check_path_launches(f"{key} {name} logits", lcounts,
                                STREAM_PATH)
            for k in STREAM_PATH:
                launches[k] += counts[k] + lcounts[k]
            per = step_bytes(rec[:len(rec) // 2])
            prologue = per.pop(-1, 0)
            check(set(per.values()) == {layer_bytes}
                  and len(per) == cfg.num_layers,
                  f"{key} {name}: bytes a step {sorted(set(per.values()))}, "
                  f"one layer is {layer_bytes}")
            with torch.no_grad():
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                ms, times, host_ms = event_ms(
                    lambda: tf.hidden_states(streamed, c, fb, None, *specs),
                    STREAM_WARM, STREAM_TIMED)
                peak = torch.cuda.max_memory_allocated()
            row[name] = {"ms": ms, "times": times, "host_ms": host_ms,
                         "x_resident": ms / res_ms,
                         "prologue_bytes": prologue,
                         "step_bytes": sorted(set(per.values())),
                         "base_gb": base / 1e9, "peak_gb": peak / 1e9,
                         "launches": {k: counts[k] + lcounts[k]
                                      for k in STREAM_PATH}}
            print(f"layer streaming {key} {name}: {ms:.3f} ms a pass "
                  f"({ms / res_ms:.3f}x resident; {times}; the host issued "
                  f"it in {host_ms:.3f} ms); bytes a step "
                  f"{layer_bytes} (one layer) after a {prologue}-byte "
                  f"prologue; peak {(peak - base) / 1e9:.3f} GB above the "
                  f"{base / 1e9:.3f} GB held before the pass; hidden states "
                  f"and "
                  f"logits == resident bit for bit; launches "
                  f"{row[name]['launches']} [{card}]", flush=True)
    out["shapes"] = shapes

    # the gradient: a remat step under gpp (G = 3), host leaves' gradients
    # brought back to the host
    t = time.perf_counter()
    c = settings("gpp", STREAM_GRAD_RING)
    (loss, grads), counts = counted(value_and_grad, c, streamed, gb, None,
                                    *specs)
    grad_s = time.perf_counter() - t
    check_path_launches("streamed gradient", counts, STREAM_PATH)
    for k in STREAM_PATH:
        launches[k] += counts[k]
    grads = named_leaves(grads)
    (l0, g0), (l1, g1) = res
    repeats = float(l0) == float(l1) and all(torch.equal(g0[k], g1[k])
                                             for k in g0)
    worst = {}
    for k, g in grads.items():
        d = float((g.cpu().float() - g0[k].float()).abs().max())
        self_d = float((g1[k].float() - g0[k].float()).abs().max())
        worst[k] = (d, self_d)
        check(d == 0.0 if repeats else d <= self_d,
              f"streamed gradient {k}: {d} from resident's "
              f"(resident from itself {self_d})")
    check(float(loss) == float(l0) if repeats
          else abs(float(loss) - float(l0)) <= abs(float(l1) - float(l0)),
          f"streamed loss {float(loss)} against resident's {float(l0)}, "
          f"{float(l1)}")
    bits = sum(same_bits(g.cpu(), g0[k]) for k, g in grads.items())
    out["grad"] = {"ring": STREAM_GRAD_RING, "tokens": [TRAIN_B, TRAIN_S],
                   "loss": float(loss), "resident_loss": float(l0),
                   "resident_repeats": repeats, "leaves": len(grads),
                   "leaves_same_bits": bits, "seconds": grad_s,
                   "launches": {k: counts[k] for k in STREAM_PATH},
                   "host_leaves": sum(not g.is_cuda
                                      for g in grads.values())}
    print(f"layer streaming grad gpp G={STREAM_GRAD_RING} remat "
          f"{TRAIN_B}x{TRAIN_S}: loss {float(loss)!r} (resident "
          f"{float(l0)!r}, again {float(l1)!r}); {len(grads)} leaves "
          f"({out['grad']['host_leaves']} brought back to the host) equal "
          f"resident's, {bits} of them bit for bit; {grad_s:.2f} s; launches "
          f"{out['grad']['launches']} [{card}]", flush=True)
    out["launches"] = launches
    return out


SHARDED_DS = ("gpp_matmul_tc", "gpp_matmul", "gpp_matmul_grouped_tc",
              "rmsnorm")
SHARDED_DS_F32 = ("gpp_matmul", "gpp_matmul_grouped", "rmsnorm")
SHARDED_B, SHARDED_S, SHARDED_N = 4, 32, 16   # prefill 4 x 32, 16 decodes
SHARDED_LAYERS = 4             # deepseek: its dense layer and 3 MoE layers
SHARDED_XL_LAYERS = 4          # xlstm: 2 mLSTM + 2 sLSTM of 48
SHARDED_Z = (6, 1, 256)        # zamba2: one superblock; prefill 1 x 256
SHARDED_LV = (5, 4, 32)        # llama-vision: one superblock; prefill 4 x 32
KV_CHUNK_CASE = (28, 4, 128, 4096)            # qwen2-7b's heads, T
DONATION_B, DONATION_T = 12, 32768            # qwen1.5-0.5b: 38.65 GB bf16
DONATION_STEPS = 3             # timed decode steps after the gated one


def _sharded_serve(mesh, cfg, params, prompt, nxt, enc=None):
    """`make_prefill_step` over `prompt` (B, S) then `make_decode_step`
    len(nxt) times on the mesh, the given tokens fed (no sampling), `enc`
    the encoder embeddings of a cross layer: the logits of every step,
    (B, 1 + N, vocab), and a dict of the peak HBM of each step kind and
    the decode steps' mean ms (CUDA events around the N calls)."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    B, S = prompt.shape
    T = S + len(nxt)
    pre = steps.make_prefill_step(
        cfg, mesh, ShapeConfig("prefill", T, B, "prefill"))
    dec = steps.make_decode_step(
        cfg, mesh, ShapeConfig("decode", T, B, "decode"))
    batch = {"tokens": prompt} | ({} if enc is None else {"enc": enc})
    peak = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits, caches = pre.fn(params, batch)
    torch.cuda.synchronize()
    peak["prefill_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    torch.cuda.reset_peak_memory_stats()
    out = [logits]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for i in range(len(nxt)):
        logits, caches = dec.fn(params, nxt[i], caches, S + i, enc)
        out.append(logits)
    ev[1].record()
    torch.cuda.synchronize()
    peak["decode_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    peak["decode_max_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    peak["decode_ms"] = ev[0].elapsed_time(ev[1]) / len(nxt)
    if cfg.num_experts:
        check(dec.meta["cfg"].moe_serve_resident,
              "the decode step keeps the experts resident")
    return torch.cat(out, dim=1), peak


def _meshless_serve(cfg, params, prompt, nxt, enc=None):
    """The same tokens through the mesh-less `transformer.prefill` /
    `decode_step`."""
    import torch
    from repro_torch.models import transformer as tf
    S = prompt.shape[1]
    batch = {"tokens": prompt} | ({} if enc is None else {"enc": enc})
    with torch.no_grad():
        logits, caches = tf.prefill(params, cfg, batch, S + len(nxt))
        out = [logits]
        for i in range(len(nxt)):
            logits, caches = tf.decode_step(params, cfg, nxt[i], caches,
                                            S + i, enc=enc)
            out.append(logits)
    return torch.cat(out, dim=1)


def _row_err(got, want) -> float:
    """max over rows of max |got - want| / the row's largest |want|."""
    w = want.float()
    return float(((got.float() - w).abs().amax(-1)
                  / w.abs().amax(-1).clamp(min=1e-30)).max())


@contextlib.contextmanager
def _calls(module, *names):
    """Count the calls of module-level functions inside the block."""
    calls = dict.fromkeys(names, 0)
    inner = {n: getattr(module, n) for n in names}

    def wrap(n):
        def f(*a, **kw):
            calls[n] += 1
            return inner[n](*a, **kw)
        return f
    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(module, n, inner[n])


class _TopK:
    """Stands for `torch` inside a module: every attribute is torch's but
    `topk`, which records its indices (`forced` None) or returns the
    recorded ones, in order, with their values gathered from its input;
    `moved` counts the choices its own top-k would have changed."""

    def __init__(self, forced=None):
        self.indices = [] if forced is None else None
        self.forced = None if forced is None else iter(forced)
        self.moved = self.choices = 0

    def __getattr__(self, name):
        import torch
        return getattr(torch, name)

    def topk(self, x, k, dim=-1):
        import torch
        values, idx = torch.topk(x, k, dim=dim)
        if self.forced is None:
            self.indices.append(idx)
            return values, idx
        want = next(self.forced)
        self.moved += int((torch.sort(want, dim)[0]
                           != torch.sort(idx, dim)[0]).any(dim).sum())
        self.choices += idx.numel() // k
        return torch.gather(x, dim, want), want


@contextlib.contextmanager
def _experts(module, forced=None):
    """`module`'s top-k recorded (forced None) or forced (`_TopK`)."""
    real = module.torch
    module.torch = _TopK(forced)
    try:
        yield module.torch
    finally:
        module.torch = real


def _sharded_deepseek(out, mesh, card, launches):
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import tree_map
    arch = "deepseek-v2-lite-16b"
    gen = torch.Generator().manual_seed(5)
    cfg0 = registry.get_config(arch).with_(num_layers=SHARDED_LAYERS)
    prompt = torch.randint(0, cfg0.vocab_size, (SHARDED_B, SHARDED_S),
                           generator=gen).cuda()
    nxt = torch.randint(0, cfg0.vocab_size, (SHARDED_N, SHARDED_B, 1),
                        generator=gen).cuda()
    res = out["deepseek"] = {"layers": SHARDED_LAYERS,
                             "prefill": [SHARDED_B, SHARDED_S],
                             "decode_steps": SHARDED_N}
    # bf16, the kernels against the plain route, at a capacity that drops
    # no token (C = T at E / k), so a token routed apart on the two routes
    # moves no other token's slot; drops are held to the reference on the
    # CPU (tests/test_torch_dist_world1.py)
    cfg, params = _model(arch, "bfloat16", SHARDED_LAYERS)
    check(cfg.prefix_pattern == ("dense",) and cfg.num_superblocks == 3,
          f"{arch}: {cfg.prefix_pattern} + {cfg.num_superblocks} MoE")
    cfg = cfg.with_(moe_capacity_factor=cfg.num_experts
                    / cfg.experts_per_token)
    t = time.perf_counter()
    with _calls(moe_mod, "_moe_shard_map", "_moe_shard_map_serve") as calls, \
            _experts(moe_mod) as chosen:
        (ker, peak), counts = counted(_sharded_serve, mesh, cfg, params,
                                      prompt, nxt)
    res["bf16_s"] = time.perf_counter() - t
    # 3 MoE layers: once each in the prefill, once each a decode step
    check(calls == {"_moe_shard_map": 3,
                    "_moe_shard_map_serve": 3 * SHARDED_N},
          f"sharded {arch}: MoE forms called {calls}")
    res["moe_forms"] = calls
    check_path_launches(f"sharded {arch} bf16", counts, SHARDED_DS)
    # bf16 rounds the two routes' hidden states apart, and the router's
    # top-6 of 64 near-uniform random-weight probabilities moves with them
    # (a token routed apart is another function): the plain run takes the
    # kernel run's expert choices, its own counted
    with _experts(moe_mod, chosen.indices) as forced:
        (plain, _), pcounts = counted(_sharded_serve, mesh,
                                      cfg.with_(dense_kernel="ref"), params,
                                      prompt, nxt)
    check_path_launches(f"sharded {arch} bf16 plain", pcounts, ())
    # the same weights in f32 on the same expert choices: how far bf16
    # itself puts each route
    p32 = tree_map(lambda t: t.float(), params)
    with _experts(moe_mod, chosen.indices):
        (ref32, _), _ = counted(_sharded_serve, mesh,
                                cfg.with_(dtype="float32"), p32, prompt, nxt)
    del p32
    # the path's bf16 tolerance, 2e-2 + 2e-2 x |plain|, with |plain| a row's
    # largest |logit| (as the f32 gates read a row's scale): through 4
    # layers bf16 puts either route ~0.03 from the f32 run of the same
    # weights, the two routes ~0.02 apart, so a few of a step's 409,600
    # logits near 0 sit past the elementwise reading (counted, printed)
    err = (ker.float() - plain.float()).abs()
    bound = 2e-2 + 2e-2 * plain.float().abs()
    row_bound = 2e-2 + 2e-2 * plain.float().abs().amax(-1, keepdim=True)
    res["bf16_elementwise_over"] = int((err > bound).sum())
    res["bf16_logits"] = err.numel()
    res["bf16_by_step"] = [
        {"max_abs_err": float(err[:, i].max()),
         "over": int((err[:, i] > bound[:, i]).sum()),
         "max_abs_logit": float(plain[:, i].float().abs().max()),
         "kernel_vs_f32": float((ker[:, i].float() - ref32[:, i]).abs()
                                .max()),
         "plain_vs_f32": float((plain[:, i].float() - ref32[:, i]).abs()
                               .max())}
        for i in range(1 + SHARDED_N)]
    print(f"sharded steps [{card}]: {arch} bf16 kernel vs plain by step "
          f"(max |err|, elements over 2e-2 + 2e-2 x |plain| of "
          f"{err[:, 0].numel()}, max |logit|, kernel / plain from the f32 "
          f"run of the same weights): "
          + "; ".join(f"{r['max_abs_err']:.4f} {r['over']} "
                      f"{r['max_abs_logit']:.3f} {r['kernel_vs_f32']:.4f} / "
                      f"{r['plain_vs_f32']:.4f}"
                      for r in res["bf16_by_step"]), flush=True)
    check(bool((err <= row_bound).all()),
          f"sharded {arch} bf16: logits {float(err.max())} from the plain "
          f"route's (2e-2 + 2e-2 x a row's largest |plain|)")
    # the row bound is loose: also hold the kernels' own error, each step's
    # distance from the f32 run against the plain route's from it, and the
    # elements past the elementwise reading to 1e-5 of the logits
    for i, r in enumerate(res["bf16_by_step"]):
        check(r["kernel_vs_f32"] <= 1.5 * r["plain_vs_f32"] + 5e-3,
              f"sharded {arch} bf16 step {i}: kernel route "
              f"{r['kernel_vs_f32']} from the f32 run, plain route "
              f"{r['plain_vs_f32']} (bound 1.5 x plain + 5e-3)")
    check(res["bf16_elementwise_over"] <= 1e-5 * err.numel(),
          f"sharded {arch} bf16: {res['bf16_elementwise_over']} of "
          f"{err.numel()} logits past 2e-2 + 2e-2 x |plain| (at most 1e-5 "
          f"of them)")
    res.update(bf16_launches=counts, bf16_peak=peak,
               bf16_decode_ms=peak["decode_ms"],
               bf16_max_abs_err=float(err.max()),
               bf16_plain_topk_moved=forced.moved,
               bf16_topk_choices=forced.choices)
    for k in SHARDED_DS:
        launches[k] = launches.get(k, 0) + counts[k]
    del params, ker, plain
    torch.cuda.empty_cache()
    # f32 at the same capacity: the mesh steps' one dispatch group then
    # equals the mesh-less steps' groups
    cfg = cfg.with_(dtype="float32")
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    (ker, peak), counts = counted(_sharded_serve, mesh, cfg, params, prompt,
                                  nxt)
    check_path_launches(f"sharded {arch} f32", counts, SHARDED_DS_F32)
    (plain, _), pcounts = counted(_sharded_serve, mesh,
                                  cfg.with_(dense_kernel="ref"), params,
                                  prompt, nxt)
    check_path_launches(f"sharded {arch} f32 plain", pcounts, ())
    meshless = _meshless_serve(cfg, params, prompt, nxt)
    e_plain, e_meshless = _row_err(ker, plain), _row_err(ker, meshless)
    check(e_plain <= 1e-3, f"sharded {arch} f32: logits rows {e_plain} of "
          f"their scale from the plain route's")
    check(e_meshless <= 1e-3, f"sharded {arch} f32: logits rows "
          f"{e_meshless} of their scale from the mesh-less steps'")
    res.update(f32_launches=counts, f32_peak=peak, f32_vs_plain=e_plain,
               f32_vs_meshless=e_meshless)
    for k in SHARDED_DS_F32:
        launches[f"{k} f32"] = launches.get(f"{k} f32", 0) + counts[k]
    del params, ker, plain, meshless
    torch.cuda.empty_cache()
    print(f"sharded steps [{card}]: {arch} {SHARDED_LAYERS} layers on the "
          f"1x1 NCCL mesh, prefill {SHARDED_B}x{SHARDED_S} (_moe_shard_map) "
          f"+ {SHARDED_N} decode steps (_moe_shard_map_serve): bf16 logits "
          f"within 2e-2 + 2e-2 x a row's largest |plain| of the plain route "
          f"on the kernel run's expert choices (max "
          f"{res['bf16_max_abs_err']:.3e}; "
          f"{res['bf16_elementwise_over']} of {res['bf16_logits']} past "
          f"2e-2 + 2e-2 x |plain| elementwise, at most 1e-5 of them; each "
          f"step's kernel route within 1.5 x the plain route's distance "
          f"from the f32 run + 5e-3; the "
          f"plain run's own top-k would have moved "
          f"{res['bf16_plain_topk_moved']} of {res['bf16_topk_choices']} "
          f"tokens' choices), launches {res['bf16_launches']}, "
          f"peak prefill {res['bf16_peak']['prefill_gb']:.3f} GB decode "
          f"{res['bf16_peak']['decode_gb']:.3f} GB; f32 rows {e_plain:.3e} "
          f"of their scale from plain, {e_meshless:.3e} from the mesh-less "
          f"steps at capacity {cfg.moe_capacity_factor:.3f}", flush=True)


def _sharded_qwen_train(out, mesh, card, launches):
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import adamw
    arch = "qwen1.5-0.5b"
    cfg, params = _model(arch, "bfloat16")
    batch = train_batch(cfg, TRAIN_B, TRAIN_S)
    one = steps.make_train_step(cfg)
    on = steps.make_step(cfg, mesh, ShapeConfig("t", TRAIN_S, TRAIN_B,
                                                "train"))
    res = out["qwen_train"] = {"tokens": [TRAIN_B, TRAIN_S],
                               "layers": cfg.num_layers}
    # the loss and every gradient leaf
    l1, g1 = steps.value_and_grad(cfg, params, batch)
    (l2, g2), counts = counted(on.meta["loss_and_grads"], params, batch)
    check_path_launches("sharded qwen gradient", counts, TRAIN_PATH)
    check(same_bits(l1, l2), f"sharded qwen loss {float(l2)!r} against the "
          f"mesh-less {float(l1)!r}")
    g1, g2 = named_leaves(g1), named_leaves(g2)
    check(set(g1) == set(g2), "sharded qwen: gradient leaves")
    for k in g1:
        check(same_bits(g1[k], g2[k]), f"sharded qwen gradient {k}")
    del g1, g2
    # one AdamW step each: the loss, grad norm and every updated leaf; a
    # step updates the parameters and state it is given in place, so each
    # gets copies (made before its peak is read)
    steps_s, peaks, news, allocated = {}, {}, {}, {}
    for name, b in (("meshless", one), ("mesh", on)):
        for i in range(2):                   # the second is timed
            mine = tree_map(torch.clone, params)
            state = adamw.adamw_init(params)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            (p, _, m), c = counted(b.fn, mine, state, batch, 0)
            steps_s[name] = time.perf_counter() - t
            peaks[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
            allocated[name] = torch.cuda.max_memory_allocated() / 1e9
            if name == "mesh":
                check_path_launches("sharded qwen train step", c,
                                    TRAIN_PATH)
                if i == 0:
                    for k in TRAIN_PATH:
                        launches[k] = launches.get(k, 0) + c[k]
            news[name] = (named_leaves(p), m)
            del mine, state
    (p1, m1), (p2, m2) = news["meshless"], news["mesh"]
    for k in ("loss", "grad_norm"):
        check(same_bits(m1[k], m2[k]), f"sharded qwen step {k}: "
              f"{float(m2[k])!r} against {float(m1[k])!r}")
    for k in p1:
        check(same_bits(p1[k], p2[k]), f"sharded qwen updated {k}")
    tok = TRAIN_B * TRAIN_S
    res.update(loss=float(m2["loss"]), grad_norm=float(m2["grad_norm"]),
               leaves=len(p1), launches=counts,
               tok_s={k: tok / v for k, v in steps_s.items()},
               step_s=steps_s, peak_gb=peaks, max_allocated_gb=allocated)
    del params, news, p1, p2
    torch.cuda.empty_cache()
    print(f"sharded steps [{card}]: {arch} train step ({cfg.num_layers} "
          f"layers, {TRAIN_B}x{TRAIN_S}, bf16, AdamW, remat) on the 1x1 NCCL "
          f"mesh == the mesh-less step bit for bit (loss {res['loss']!r}, "
          f"grad norm {res['grad_norm']!r}, every gradient leaf and "
          f"{res['leaves']} updated leaves); tok/s mesh-less "
          f"{res['tok_s']['meshless']:.0f}, mesh {res['tok_s']['mesh']:.0f}; "
          f"peak {peaks}", flush=True)


def _ulps(a, b) -> float:
    """The largest |a - b| over one step of a's dtype at a (the spacing of
    a's binade; the smallest normal's at 0)."""
    import torch
    fi = torch.finfo(a.dtype)
    af = a.float()
    _, e = torch.frexp(af.abs().clamp(min=fi.tiny))
    step = fi.eps * torch.pow(2.0, (e - 1).float())
    return float(((af - b.float()).abs() / step).max())


def _sharded_xlstm_train(out, mesh, card, launches):
    """xlstm-1.3b at full width, SHARDED_XL_LAYERS layers (mLSTM + sLSTM
    superblocks), Adafactor, one train step on the 1x1 mesh against one
    mesh-less: the loss and every gradient leaf (as each step hands them
    to `adafactor_update`) bit for bit, every updated leaf within one
    step of its dtype at each element; each step timed after a mesh-less
    warm-up."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import adafactor
    arch = "xlstm-1.3b"
    t = time.perf_counter()
    cfg, params = _model(arch, "bfloat16", SHARDED_XL_LAYERS)
    cfg = cfg.with_(optimizer="adafactor")
    check(cfg.pattern == ("mlstm", "slstm") and cfg.num_superblocks == 2,
          f"{arch}: {cfg.pattern} x {cfg.num_superblocks}")
    batch = train_batch(cfg, TRAIN_B, TRAIN_S)
    res = out["xlstm_train"] = {"tokens": [TRAIN_B, TRAIN_S],
                                "layers": cfg.num_layers,
                                "optimizer": "adafactor"}
    grads = []
    inner = adafactor.adafactor_update

    def update(c, g, *a, **kw):
        grads.append(named_leaves(g))
        return inner(c, g, *a, **kw)
    steps_s, peaks, news = {}, {}, {}
    one = steps.make_train_step(cfg)
    on = steps.make_step(cfg, mesh, ShapeConfig("t", TRAIN_S, TRAIN_B,
                                                "train"))
    adafactor.adafactor_update = update
    try:
        # the first (mesh-less) run warms the allocator; the two after it
        # are timed
        for name, b in (("meshless", one), ("mesh", on),
                        ("meshless again", one)):
            # the step updates what it is given in place: copies
            mine = tree_map(torch.clone, params)
            state = adafactor.adafactor_init(params)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t1 = time.perf_counter()
            (p, _, m), c = counted(b.fn, mine, state, batch, 0)
            steps_s[name] = time.perf_counter() - t1
            peaks[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
            check_path_launches(f"sharded xlstm train step ({name})", c,
                                TRAIN_PATH)
            if name == "mesh":
                res["launches"] = c
                for k in TRAIN_PATH:
                    launches[k] = launches.get(k, 0) + c[k]
            if name != "meshless again":
                news[name] = (named_leaves(p), m)
            del p, mine, state
    finally:
        adafactor.adafactor_update = inner
    steps_s["meshless"] = steps_s.pop("meshless again")
    (p1, m1), (p2, m2) = news["meshless"], news["mesh"]
    check(same_bits(m1["loss"], m2["loss"]), f"sharded xlstm loss "
          f"{float(m2['loss'])!r} against the mesh-less "
          f"{float(m1['loss'])!r}")
    g1, g2 = grads[:2]
    check(set(g1) == set(g2), "sharded xlstm: gradient leaves")
    for k in g1:
        check(same_bits(g1[k], g2[k]), f"sharded xlstm gradient {k}")
    ulps = {k: _ulps(p1[k], p2[k]) for k in p1}
    differ = sum(int((p1[k] != p2[k]).sum()) for k in p1)
    worst = max(ulps, key=ulps.get)
    check(ulps[worst] <= 1.0, f"sharded xlstm updated {worst}: "
          f"{ulps[worst]} steps of its dtype from the mesh-less update")
    tok = TRAIN_B * TRAIN_S
    res.update(loss=float(m2["loss"]), grad_norm=float(m2["grad_norm"]),
               leaves=len(p1), max_ulps=ulps[worst],
               elements_differing=differ,
               tok_s={k: tok / v for k, v in steps_s.items()},
               step_s=steps_s, peak_gb=peaks,
               seconds=time.perf_counter() - t)
    del params, news, p1, p2, grads, g1, g2
    torch.cuda.empty_cache()
    print(f"sharded steps [{card}]: {arch} Adafactor train step "
          f"({cfg.num_layers} layers, {TRAIN_B}x{TRAIN_S}, bf16, remat) on "
          f"the 1x1 NCCL mesh: loss {res['loss']!r} and every gradient leaf "
          f"bit for bit the mesh-less step's; {res['leaves']} updated leaves "
          f"within {res['max_ulps']} steps of their dtype "
          f"({differ} elements differ); tok/s mesh-less "
          f"{res['tok_s']['meshless']:.0f}, mesh {res['tok_s']['mesh']:.0f}; "
          f"peak {peaks}; launches {res['launches']}; "
          f"{res['seconds']:.1f} s", flush=True)


def _sharded_serve_model(out, mesh, card, launches, arch, layers, B, S,
                         key):
    """`arch` at full width, `layers` layers, `make_prefill_step` (B x S)
    and SHARDED_N `make_decode_step`s on the 1x1 mesh (encoder embeddings
    for a cross layer), bf16 on the kernel and the plain routes and f32 on
    the same weights: each step's bf16 kernel route within 1.5 x the plain
    route's distance from the f32 run + 5e-3 (deepseek's gate: both
    routes round bf16 apart); the f32 logits against the plain route and
    the mesh-less `prefill` / `decode_step`, rows within 1e-3 of their
    scale; the launches of each run and its peak HBM."""
    import torch
    from repro_torch.models.layers import tree_map
    t = time.perf_counter()
    cfg, params = _model(arch, "bfloat16", layers)
    gen = torch.Generator().manual_seed(6)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen).cuda()
    nxt = torch.randint(0, cfg.vocab_size, (SHARDED_N, B, 1),
                        generator=gen).cuda()
    enc = None
    if cfg.encoder_tokens:
        enc = torch.randn((B, cfg.encoder_tokens, cfg.d_model),
                          generator=gen).cuda()
    res = out[key] = {"layers": layers, "pattern": list(cfg.pattern),
                      "prefill": [B, S], "decode_steps": SHARDED_N}
    (ker, peak), counts = counted(_sharded_serve, mesh, cfg, params, prompt,
                                  nxt, enc)
    check_path_launches(f"sharded {arch} bf16", counts, TRAIN_PATH)
    (plain, _), pcounts = counted(_sharded_serve, mesh,
                                  cfg.with_(dense_kernel="ref"), params,
                                  prompt, nxt, enc)
    check_path_launches(f"sharded {arch} bf16 plain", pcounts, ())
    res.update(bf16_launches=counts, bf16_peak=peak)
    for k in TRAIN_PATH:
        launches[k] = launches.get(k, 0) + counts[k]
    params = tree_map(lambda w: w.float(), params)
    cfg = cfg.with_(dtype="float32")
    (f32, peak), counts = counted(_sharded_serve, mesh, cfg, params, prompt,
                                  nxt, enc)
    check_path_launches(f"sharded {arch} f32", counts, TRAIN_F32)
    err = (ker.float() - plain.float()).abs()
    res["bf16_by_step"] = [
        {"max_abs_err": float(err[:, i].max()),
         "row_err": _row_err(ker[:, i], plain[:, i]),
         "max_abs_logit": float(plain[:, i].float().abs().max()),
         "kernel_vs_f32": float((ker[:, i].float() - f32[:, i]).abs().max()),
         "plain_vs_f32": float((plain[:, i].float() - f32[:, i]).abs()
                               .max())}
        for i in range(1 + SHARDED_N)]
    for i, r in enumerate(res["bf16_by_step"]):
        check(r["kernel_vs_f32"] <= 1.5 * r["plain_vs_f32"] + 5e-3,
              f"sharded {arch} bf16 step {i}: kernel route "
              f"{r['kernel_vs_f32']} from the f32 run, plain route "
              f"{r['plain_vs_f32']} (bound 1.5 x plain + 5e-3)")
    del ker, plain
    (plain, _), pcounts = counted(_sharded_serve, mesh,
                                  cfg.with_(dense_kernel="ref"), params,
                                  prompt, nxt, enc)
    check_path_launches(f"sharded {arch} f32 plain", pcounts, ())
    meshless = _meshless_serve(cfg, params, prompt, nxt, enc)
    e_plain, e_meshless = _row_err(f32, plain), _row_err(f32, meshless)
    check(e_plain <= 1e-3, f"sharded {arch} f32: logits rows {e_plain} of "
          f"their scale from the plain route's")
    check(e_meshless <= 1e-3, f"sharded {arch} f32: logits rows "
          f"{e_meshless} of their scale from the mesh-less steps'")
    res.update(f32_launches=counts, f32_peak=peak, f32_vs_plain=e_plain,
               f32_vs_meshless=e_meshless,
               seconds=time.perf_counter() - t)
    for k in TRAIN_F32:
        launches[f"{k} f32"] = launches.get(f"{k} f32", 0) + counts[k]
    del params, f32, plain, meshless
    torch.cuda.empty_cache()
    print(f"sharded steps [{card}]: {arch} {layers} layers "
          f"{tuple(cfg.pattern)} on the 1x1 NCCL mesh, prefill {B}x{S}"
          f"{'' if enc is None else f' over {cfg.encoder_tokens} patch embeddings'}"
          f" + {SHARDED_N} decode steps: bf16 kernel / plain route from the "
          f"f32 run of the same weights by step (kernel vs plain max |err|, "
          f"of a row's largest |plain|): "
          + "; ".join(f"{r['kernel_vs_f32']:.4f} / {r['plain_vs_f32']:.4f} "
                      f"({r['max_abs_err']:.4f}, {r['row_err']:.4f})"
                      for r in res["bf16_by_step"])
          + f"; launches {res['bf16_launches']}, peak prefill "
          f"{res['bf16_peak']['prefill_gb']:.3f} GB decode "
          f"{res['bf16_peak']['decode_gb']:.3f} GB; f32 rows {e_plain:.3e} "
          f"of their scale from plain, {e_meshless:.3e} from the mesh-less "
          f"steps, launches {counts}; {res['seconds']:.1f} s", flush=True)


def _kv_chunked(out, card):
    """`_sdpa_kv_chunked` against `_sdpa` at qwen2-7b's 28 / 4 heads x 128,
    T = 4096: the whole q, and a quarter of q at q_offset 1024 (a
    context-parallel rank's rows), causal and with gemma3's 1024 window,
    in f32 (2e-4 + 2e-4 x |plain|) and bf16 (2e-2 + 2e-2 x |plain|)."""
    import math
    import torch
    from repro_torch.models.attention import (_sdpa, _sdpa_kv_chunked,
                                              causal_mask)
    H, KVH, hd, T = KV_CHUNK_CASE
    gen = torch.Generator(device="cuda").manual_seed(7)
    scale = 1.0 / math.sqrt(hd)
    rows = out["kv_chunked"] = []
    for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
        q, k, v = (torch.randn((1, T, h, hd), generator=gen, device="cuda")
                   .to(dtype) for h in (H, KVH, KVH))
        for window in (None, 1024):
            for lo, n in ((0, T), (1024, T // 4)):
                qq = q[:, lo:lo + n]
                want = _sdpa(qq, k, v, causal_mask(n, T, lo, window,
                                                   q.device), scale)
                got = _sdpa_kv_chunked(qq, k, v, scale, window=window,
                                       q_offset=lo)
                err = (got.float() - want.float()).abs()
                ok = bool((err <= tol + tol * want.float().abs()).all())
                what = (f"_sdpa_kv_chunked {str(dtype)[6:]} window {window} "
                        f"rows {lo}:{lo + n}")
                check(ok, f"{what}: {float(err.max())} from _sdpa")
                rows.append({"dtype": str(dtype)[6:], "window": window,
                             "q_offset": lo, "rows": n,
                             "max_abs_err": float(err.max())})
        del q, k, v
    torch.cuda.empty_cache()
    print(f"sharded steps [{card}]: _sdpa_kv_chunked == _sdpa within "
          f"tolerance at {H}/{KVH} heads x {hd}, T {T}: "
          + "; ".join(f"{r['dtype']} w{r['window']} @{r['q_offset']} "
                      f"{r['max_abs_err']:.2e}" for r in rows), flush=True)


def check_donation(report, mesh, launches):
    """The steps' buffer donation (slice 19) on the 1x1 NCCL mesh, at
    qwen1.5-0.5b's full width and depth in bf16, B = DONATION_B rows.  (1)
    `make_decode_step` over a DONATION_T / 2-position cache, where a copy
    fits beside it, against the functional `transformer.decode_step` (the
    same code on a copy of the cache) under the same mesh: logits and the
    K / V written at the position bit for bit, the functional step's input
    left as it was.  (2) `make_decode_step` over a DONATION_T-position
    cache (random bf16, 38.65 GB, which the card cannot hold twice beside
    the step), at its last position: the step allocates less than a
    quarter of the cache's bytes above `torch.cuda.memory_allocated()`
    before it (room for `_sdpa`'s f32 copies of one layer's K / V),
    returns the tree it was given (every leaf's `data_ptr`), launches the
    path's kernels, finite logits; then DONATION_STEPS more steps timed by
    CUDA events.  (3) the train step (4 x 1024, AdamW, remat, step 200) on
    the mesh, which updates the parameters and the state in place, beside
    the mesh-less functional route (`value_and_grad`, then `adamw_update`
    copying the parameters and the state): the updated parameters bit for
    bit, and the peak above the arguments and
    `torch.cuda.max_memory_allocated` of each, printed."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.collectives import on_mesh
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import map_specs, tree_leaves, tree_map
    from repro_torch.optim import adamw
    card = report["card"]
    out = report["donation"] = {"card": card}
    t0 = time.perf_counter()
    arch, B = "qwen1.5-0.5b", DONATION_B
    cfg, params = _model(arch, "bfloat16")
    gen = torch.Generator(device="cuda").manual_seed(9)
    tok = torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                        device="cuda")

    def random_caches(T):
        caches = map_specs(lambda _, sp: torch.empty(
            sp.shape, dtype=sp.dtype, device="cuda"),
            tf.cache_specs(cfg, B, T))
        for leaf in tree_leaves(caches):
            for layer in leaf:               # (L, B, T, KVH, hd)
                layer.normal_(generator=gen)
        return caches

    def slot(caches, pos):
        return {n: t[:, :, pos].clone()
                for n, t in caches["blocks"]["b0"].items()}

    # (1) bits against the functional decode, at half the positions
    T = DONATION_T // 2
    dec = steps.make_decode_step(cfg, mesh,
                                 ShapeConfig("donation", T, B, "decode"))
    caches, pos = random_caches(T), T - 1
    before = slot(caches, pos)
    with torch.no_grad(), on_mesh(mesh, dec.meta["rules"],
                                  batch_split=True):
        want, wc = tf.decode_step(
            params, dec.meta["cfg"], tok, caches, pos, mesh=mesh,
            specs=dec.meta["param_pspecs"],
            cache_specs=dec.meta["cache_pspecs"])
    want_slot = slot(wc, pos)
    del wc
    check(all(same_bits(t, before[n]) for n, t in slot(caches, pos).items()),
          f"donation {arch}: the functional decode wrote its input")
    logits, got = dec.fn(params, tok, caches, pos)
    check(got is caches and same_bits(logits, want)
          and all(same_bits(t, want_slot[n])
                  for n, t in slot(got, pos).items()),
          f"donation {arch}: the in-place decode at {T} positions is not "
          f"the functional decode bit for bit")
    out["bits_positions"] = T
    del caches, got, logits, want, want_slot, before
    torch.cuda.empty_cache()

    # (2) the whole cache, which only the in-place decode holds
    T = DONATION_T
    dec = steps.make_decode_step(cfg, mesh,
                                 ShapeConfig("donation", T, B, "decode"))
    caches, pos = random_caches(T), T - 1
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(caches))
    ptrs = [t.data_ptr() for t in tree_leaves(caches)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (logits, got), counts = counted(dec.fn, params, tok, caches, pos)
    peak = torch.cuda.max_memory_allocated() - base
    check_path_launches(f"donation {arch} decode", counts, TRAIN_PATH)
    for k in TRAIN_PATH:
        launches[k] = launches.get(k, 0) + counts[k]
    check(got is caches and [t.data_ptr() for t in tree_leaves(got)]
          == ptrs, f"donation {arch}: the decode step returned other "
          f"cache storage than it was given")
    check(peak < cache_bytes / 4, f"donation {arch}: the decode step "
          f"allocated {peak} B over a {cache_bytes} B cache (at most a "
          f"quarter)")
    check(tuple(logits.shape) == (B, 1, cfg.vocab_size)
          and bool(logits.isfinite().all()), f"donation {arch}: logits "
          f"{tuple(logits.shape)} finite {bool(logits.isfinite().all())}")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(DONATION_STEPS):
        logits, caches = dec.fn(params, tok, caches, pos)
    ev[1].record()
    torch.cuda.synchronize()
    out["decode"] = {"rows": B, "positions": T, "layers": cfg.num_layers,
                     "cache_bytes": cache_bytes, "peak_bytes": peak,
                     "peak_share_of_cache": peak / cache_bytes,
                     "arguments_bytes": base,
                     "max_allocated_gb":
                         torch.cuda.max_memory_allocated() / 1e9,
                     "ms": ev[0].elapsed_time(ev[1]) / DONATION_STEPS,
                     "launches": counts}
    d = out["decode"]
    print(f"donation [{card}]: {arch} decode step ({cfg.num_layers} "
          f"layers, B {B}, bf16) on the 1x1 NCCL mesh: at "
          f"{out['bits_positions']} positions bit for bit the functional "
          f"decode (logits, the K / V written); at {T} positions (a "
          f"{cache_bytes / 1e9:.2f} GB cache, at its last position) "
          f"{peak / 1e9:.3f} GB allocated above {base / 1e9:.2f} GB of "
          f"arguments ({d['peak_share_of_cache']:.4f} of the cache, at "
          f"most 0.25), max_memory_allocated {d['max_allocated_gb']:.2f} "
          f"GB, {d['ms']:.3f} ms a step (mean of {DONATION_STEPS}, CUDA "
          f"events), the leaves given returned; launches {counts}",
          flush=True)
    del caches, got, logits
    torch.cuda.empty_cache()

    # (3) the train step's peak, donated and functional
    batch = train_batch(cfg, TRAIN_B, TRAIN_S)
    on = steps.make_step(cfg, mesh, ShapeConfig("t", TRAIN_S, TRAIN_B,
                                                "train"))
    optc = adamw.AdamWConfig()
    step = 200                               # past the warm-up

    def functional(p, s):
        _, g = steps.value_and_grad(cfg, p, batch)
        return adamw.adamw_update(optc, g, s, p, lr=adamw.cosine_lr(
            step, peak=optc.lr, warmup=200, total=10_000))
    train, updated = {}, {}
    for name, fn in (("donated", lambda p, s: on.fn(p, s, batch, step)),
                     ("functional", functional)):
        mine, state = tree_map(torch.clone, params), adamw.adamw_init(params)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        p, o, _ = fn(mine, state)
        torch.cuda.synchronize()
        train[name] = {"step_s": time.perf_counter() - t,
                       "arguments_gb": base / 1e9,
                       "peak_gb": (torch.cuda.max_memory_allocated() - base)
                       / 1e9,
                       "max_allocated_gb":
                           torch.cuda.max_memory_allocated() / 1e9}
        if name == "donated":
            check(p is mine and o is state, f"donation {arch}: the train "
                  f"step returned other trees than it was given")
        updated[name] = named_leaves(p)
        del mine, state, p, o
        torch.cuda.empty_cache()
    for k, w in updated["functional"].items():
        check(same_bits(updated["donated"][k], w),
              f"donation {arch}: updated {k} differs from the functional "
              f"route's")
    out["train"] = train
    del updated, params
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    report.setdefault("phase_s", {})["donation"] = out["seconds"]
    print(f"donation [{card}]: {arch} train step ({cfg.num_layers} layers, "
          f"{TRAIN_B}x{TRAIN_S}, bf16, AdamW, remat) on the mesh with "
          f"donation == the mesh-less functional route bit for bit; "
          + "; ".join(f"{k}: peak {v['peak_gb']:.3f} GB above "
                      f"{v['arguments_gb']:.3f} GB of arguments, "
                      f"max_memory_allocated {v['max_allocated_gb']:.3f} GB, "
                      f"{v['step_s']:.3f} s" for k, v in train.items())
          + f"; phase donation: {out['seconds']:.1f} s", flush=True)
    return out


def check_sharded_steps(report):
    """The sharded step builders on a 1x1 ("data", "model") NCCL mesh (one
    card, so every collective runs over a group of one rank; parity across
    ranks stands on gloo CPU ranks, tests/test_torch_dist_*.py): (1)
    deepseek-v2-lite-16b at full width with its dense layer and 3 MoE
    layers, `make_prefill_step` (4 x 32, through `_moe_shard_map`) and 16
    `make_decode_step`s on its caches (`moe_serve_resident`, through
    `_moe_shard_map_serve`) at a capacity that drops no token: bf16
    launches of the path's kernels and the logits against the same steps
    on the plain route (which takes the kernel run's expert choices: bf16
    rounding moves the top-k of near-uniform random-weight routers), f32
    logits against the plain route and the mesh-less prefill / decode; the
    bf16 kernel run's decode steps timed by CUDA events over the 16 calls;
    (2) qwen1.5-0.5b's full-width train step (`make_step`,
    4 x 1024, bf16, AdamW, remat) bit for bit the mesh-less step's: loss,
    every gradient leaf, grad norm, every updated leaf; tok/s and
    torch.cuda.max_memory_allocated of both;
    (3) `_sdpa_kv_chunked` against `_sdpa`; (4) xlstm-1.3b at full width,
    4 of its 48 layers, with Adafactor: the train step (4 x 1024, bf16,
    remat) against the mesh-less one, the loss and every gradient leaf bit
    for bit, every updated leaf within one step of its dtype at each
    element; tok/s of both; (5) zamba2-2.7b at full width, one superblock
    (5 Mamba2 layers and the shared block), `make_prefill_step` (1 x 256)
    and 16 `make_decode_step`s at B = 1, and (6) llama-3.2-vision-11b at
    full width, one superblock (4 GQA layers and its cross layer), prefill
    (4 x 32 over 1,600 patch embeddings) and 16 decodes: the bf16 kernel
    route against the plain route, each within 1.5 x the plain route's
    distance from the f32 run of the same weights + 5e-3 (zamba2's
    recurrence carries either route's bf16 rounding far enough from f32
    that no fixed bound on the two routes' difference holds), f32 logits
    against the plain route and the mesh-less steps, gpp_matmul
    (tensor-core and FMA) and RMSNorm launches counted on each run.  At
    1x1 every collective is a group of one rank and the model axis takes
    no tensor-parallel form: the MLA / Mamba2 /
    mLSTM / sLSTM / cross / shared-attention forms across ranks, and
    Adafactor's all-reduced means, are held on gloo CPU ranks only
    (tests/test_torch_dist_mixers.py, test_torch_dist_steps.py).  Then, on
    the same mesh, `check_donation`.  Prints the NCCL start-up seconds,
    each step's peak HBM and the phase's seconds."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_rank, make_cuda_mesh
    card = report["card"]
    out = report["sharded_steps"] = {"card": card}
    t0 = time.perf_counter()
    store = tempfile.TemporaryDirectory()
    init_rank(0, 1, f"{store.name}/store", "nccl")
    try:
        mesh = make_cuda_mesh(1, 1)
        one = torch.ones(1, device="cuda")
        dist.all_reduce(one)                  # the communicator is up
        torch.cuda.synchronize()
        check(float(one) == 1.0, "an all-reduce over one rank")
        out["nccl_start_s"] = time.perf_counter() - t0
        print(f"sharded steps [{card}]: NCCL process group of one rank and "
              f"a 1x1 mesh up in {out['nccl_start_s']:.2f} s", flush=True)
        launches = out["launches"] = {}
        _sharded_deepseek(out, mesh, card, launches)
        _sharded_qwen_train(out, mesh, card, launches)
        _kv_chunked(out, card)
        _sharded_xlstm_train(out, mesh, card, launches)
        _sharded_serve_model(out, mesh, card, launches, "zamba2-2.7b",
                             *SHARDED_Z, "zamba2")
        _sharded_serve_model(out, mesh, card, launches,
                             "llama-3.2-vision-11b", *SHARDED_LV, "vision")
        check_donation(report, mesh, launches)
    finally:
        dist.destroy_process_group()
        store.cleanup()
    out["seconds"] = time.perf_counter() - t0
    print(f"sharded steps [{card}]: {out['seconds']:.1f} s; launches "
          f"{launches}", flush=True)
    return out


ROOFLINE_DRYRUN_S = 90         # the dry run's subprocess, from its start
ROOFLINE_MAX_SHARE = 1.05      # a step faster than its bound: a wrong count


def _roofline_of(arch, cfg, shape):
    """`cfg`'s step at `shape` counted on meta on a fake 1x1 mesh (the
    builder and code path the measured steps ran on the 1x1 NCCL mesh;
    a collective over one rank counts no bytes): the dry-run record and
    its roofline on `repro_torch.launch.roofline`'s H100 constants."""
    from repro_torch.launch import dryrun, roofline
    rec = dryrun.run_cell(arch, shape.name, False, cfg=cfg, shape=shape,
                          layout=((1, 1), ("data", "model")), verbose=False)
    check(rec["ok"], f"roofline: {arch} {shape.name} on meta: "
          f"{rec.get('error')}")
    return rec, roofline.analyze_record(rec, cfg, shape)


def _roofline_row(card, what, rec, r, measured_s, peak_gb) -> dict:
    """Print and gate one measured step against its roofline."""
    from repro_torch.launch import roofline
    share = r.step_time_s / measured_s
    mfu = r.model_flops / (measured_s * roofline.PEAK_FLOPS)
    row = {"compute_s": r.compute_s, "memory_s": r.memory_s,
           "memory_dot_s": rec["dot_bytes_per_device_loop_aware"]
           / roofline.HBM_BW,
           "collective_s": r.collective_s, "bottleneck": r.bottleneck,
           "roofline_s": r.step_time_s, "measured_s": measured_s,
           "share": share, "mfu": mfu, "flops": rec["flops_per_device"],
           "model_flops": r.model_flops,
           "predicted_peak_gb": rec["hbm_bytes"] / 1e9,
           "max_allocated_gb": peak_gb, "count_s": rec["count_s"]}
    print(f"roofline [{card}]: {what}: counted on meta {row['flops']:.4e} "
          f"FLOPs (model_flops {row['model_flops']:.4e}); terms (H100 SXM5 "
          f"spec constants, not measured) compute {r.compute_s * 1e3:.3f} "
          f"ms, memory {r.memory_s * 1e3:.3f} ms (dot bytes "
          f"{row['memory_dot_s'] * 1e3:.3f}), collective "
          f"{r.collective_s * 1e3:.3f} ms -> roofline "
          f"{r.step_time_s * 1e3:.3f} ms ({r.bottleneck}); measured "
          f"{measured_s * 1e3:.3f} ms; share {share:.4f}, MFU {mfu:.4f}; "
          f"peak predicted {row['predicted_peak_gb']:.2f} GB, "
          f"torch.cuda.max_memory_allocated {peak_gb:.2f} GB; counted in "
          f"{rec['count_s']:.1f} s", flush=True)
    check(share <= ROOFLINE_MAX_SHARE, f"roofline {what}: the step ran in "
          f"{measured_s} s, under its bound {r.step_time_s} s (share "
          f"{share} > {ROOFLINE_MAX_SHARE}: the count is wrong)")
    return row


def check_roofline(report):
    """The dry run and the roofline on the card's host and against steps
    the card timed (after `check_sharded_steps`, whose times it reads):
    (1) `python -m repro_torch.launch.dryrun` for qwen1.5-0.5b train_4k on
    the 16x16 mesh in a process of its own (its fake process group must
    meet no other), within ROOFLINE_DRYRUN_S, then
    `repro_torch.launch.report` on its JSON: the cell ok and fitting, its
    row in the table; (2) meanwhile, here, qwen1.5-0.5b's full-width train
    step (4 x 1024, bf16, AdamW, remat) and deepseek-v2-lite-16b's decode
    step (4 layers, B = 4, a 48-position cache, capacity E / k, bf16)
    counted on meta, as the sharded-steps phase built and timed them: the
    three terms, the roofline step time against the measured one (the
    share, at most ROOFLINE_MAX_SHARE), the MFU (model_flops / (measured x
    PEAK_FLOPS)) and the predicted peak beside
    torch.cuda.max_memory_allocated (printed, not gated).  Launches no
    kernel."""
    import os
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import report as rep
    from repro_torch.models import registry
    card = report["card"]
    out = report["roofline"] = {"card": card}
    sharded = report["sharded_steps"]
    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    path = Path(tmp.name) / "dryrun.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen1.5-0.5b", "--shape", "train_4k", "--single-pod-only", "--out",
         str(path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        cfg = registry.get_config("qwen1.5-0.5b").with_(dtype="bfloat16")
        shape = ShapeConfig(f"train {TRAIN_B}x{TRAIN_S}", TRAIN_S, TRAIN_B,
                            "train")
        rec, r = _roofline_of("qwen1.5-0.5b", cfg, shape)
        q = sharded["qwen_train"]
        out["qwen_train"] = _roofline_row(
            card, f"qwen1.5-0.5b train step ({cfg.num_layers} layers, "
            f"{TRAIN_B}x{TRAIN_S}, bf16, AdamW, remat)", rec, r,
            q["step_s"]["mesh"], q["max_allocated_gb"]["mesh"])
        arch = "deepseek-v2-lite-16b"
        cfg = registry.get_config(arch).with_(dtype="bfloat16",
                                              num_layers=SHARDED_LAYERS)
        cfg = cfg.with_(moe_capacity_factor=cfg.num_experts
                        / cfg.experts_per_token)
        T = SHARDED_S + SHARDED_N
        shape = ShapeConfig(f"decode {SHARDED_B}x{T}", T, SHARDED_B,
                            "decode")
        rec, r = _roofline_of(arch, cfg, shape)
        d = sharded["deepseek"]
        out["deepseek_decode"] = _roofline_row(
            card, f"{arch} decode step ({SHARDED_LAYERS} layers, B "
            f"{SHARDED_B}, a {T}-position cache at its last position, bf16; "
            f"measured: the mean of {SHARDED_N} steps)", rec, r,
            d["bf16_decode_ms"] / 1e3,
            d["bf16_peak"]["decode_max_allocated_gb"])
        left = ROOFLINE_DRYRUN_S - (time.perf_counter() - t0)
        log, _ = proc.communicate(timeout=max(1.0, left))
        dry_s = time.perf_counter() - t0
        check(proc.returncode == 0, f"roofline: the dry run exited "
              f"{proc.returncode}:\n{log[-2000:]}")
        with open(path) as f:
            (cell,) = json.load(f)
        check(cell["ok"] and cell["fits"], f"roofline: the dry-run cell "
              f"{cell.get('error')} fits={cell.get('fits')}")
        rows = rep.rows_from(str(path))
        table = rep.markdown_table(rows)
        line = next((ln for ln in table.splitlines()
                     if ln.startswith("| qwen1.5-0.5b | train_4k | 16x16 |")),
                    None)
        check(line is not None and "FAILED" not in line,
              f"roofline: the report has no row for the cell:\n{table}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        tmp.cleanup()
    out["dryrun"] = {"seconds": dry_s, "count_s": cell["count_s"],
                     "hbm_gib": cell["hbm_bytes"] / 2**30,
                     "row": rows[0]}
    print(f"roofline [{card}]: python -m repro_torch.launch.dryrun --arch "
          f"qwen1.5-0.5b --shape train_4k --single-pod-only: ok, fits "
          f"({out['dryrun']['hbm_gib']:.2f} GiB a card), counted in "
          f"{cell['count_s']:.1f} s, {dry_s:.1f} s with its start; report "
          f"row (H100 SXM5 spec constants, not measured):\n{line}",
          flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out

# ---------------------------------------------------------------------------
# the examples (slice 20)
# ---------------------------------------------------------------------------

# the JAX example's printout (`PYTHONPATH=src python
# examples/gpp_design_space.py`), which its port must print character for
# character
DESIGN_SPACE_TEXT = (
    '=== design phase: band=128 B/cycle, macro 1 KiB, OU 32 B, s=4 ===\n'
    '\n'
    '  t_rw:t_pim = 0.143  (n_in=56)\n'
    '    insitu    macros=  32 latency/round=    64.0cy (x7.86) peakBW= 128.0 util=1.00\n'
    '    naive_pp  macros=  64 latency/round=    56.0cy (x6.88) peakBW= 128.0 util=0.57\n'
    '    gpp       macros= 256 latency/round=     8.1cy (x1.00) peakBW= 128.0 util=0.98\n'
    '\n'
    '  t_rw:t_pim = 1.000  (n_in=8)\n'
    '    insitu    macros=  32 latency/round=    16.0cy (x1.98) peakBW= 128.0 util=1.00\n'
    '    naive_pp  macros=  64 latency/round=     8.1cy (x1.00) peakBW= 128.0 util=0.99\n'
    '    gpp       macros=  64 latency/round=     8.1cy (x1.00) peakBW= 128.0 util=0.99\n'
    '\n'
    '  t_rw:t_pim = 4.000  (n_in=2)\n'
    '    insitu    macros=  32 latency/round=    10.0cy (x1.24) peakBW= 128.0 util=1.00\n'
    '    naive_pp  macros=  64 latency/round=     8.0cy (x1.00) peakBW= 128.0 util=0.62\n'
    '    gpp       macros=  40 latency/round=     9.3cy (x1.15) peakBW= 128.0 util=0.99\n'
    '\n'
    '=== runtime phase: bandwidth cut to band/n (design @ t_rw==t_pim) ===\n'
    '     n      gpp    naive   insitu   (remaining perf, DES)\n'
    '     2   0.7047   0.5000   0.6667   gpp keeps 1.4x naive, 1.1x insitu\n'
    '     8   0.4114   0.1250   0.2222   gpp keeps 3.3x naive, 1.9x insitu\n'
    '    32   0.2239   0.0312   0.0606   gpp keeps 7.2x naive, 3.7x insitu\n'
    '    64   0.1647   0.0156   0.0308   gpp keeps 10.5x naive, 5.4x insitu\n'
    '\n'
    'paper headline at n=64: 5.38x over in-situ — reproduced above.\n')
# torch_train_e2e.py's resident run: 100 of its 300 default steps, for the
# script's time (its loss falls from 10.58 to ~4.73 by step 99; the full
# 300-step run is recorded in PERF.md)
EXAMPLE_STEPS = 100
EXAMPLE_GPP_STEPS = 20         # its --stream-mode gpp run, against resident
EXAMPLE_RESUME = (10, 12)      # saved at 10 steps, then resumed to 12
EXAMPLE_BATCH = (16, 256)      # its default --batch and --seq
EXAMPLE_TIMEOUT_S = {"torch_quickstart": 120, "torch_serve_batched": 180,
                     "torch_train_e2e": 420}


@contextlib.contextmanager
def held_to_plain(held: dict):
    """Inside the block, every call of a kernel wrapper made through
    `kernels.ops` (`gpp_matmul`, `paged_attention` with its merge,
    `rmsnorm`) is held against its plain version on the same inputs, at
    the kernel gates' tolerances: gpp_matmul TOL's atol + rtol x |plain|
    (`gpp_case`, `check_head`), paged attention TOL's atol (`pa_case`),
    RMSNorm `rms_err`.  `held` gathers, by kernel launched, the launches
    held, their shapes and the largest error.  The plain versions launch
    none of the port's kernels, so the counts stay the path's."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as rk
    from repro_torch.kernels.ref import (dense_ref, paged_attn_ref,
                                         rmsnorm_ref)

    def dt(t):
        return str(t.dtype).split(".")[-1]

    def gpp_plain(x, w, *, bias=None, w_scale=None, activation=None, **_):
        return dense_ref(x, w, bias=bias, w_scale=w_scale,
                         activation=activation)

    def gpp_err(y, ref, x, *_):
        atol, rtol = TOL["float32" if x.dtype == torch.float32
                         else "bfloat16"]
        d = (y.float() - ref.float()).abs()
        return float(d.max()), bool((d <= atol + rtol * ref.float().abs())
                                    .all())

    def pa_plain(q, a, b, tables, pos, *, num_kv_heads, scale, window=None,
                 mla=False, **_):
        return paged_attn_ref(q, a, b, tables, pos, num_kv_heads=num_kv_heads,
                              scale=scale, window=window, mla=mla)

    def pa_err(y, ref, q, *_):
        err = float((y.float() - ref.float()).abs().max())
        return err, err <= TOL[dt(q)][0]

    def rms_plain(x, scale, eps=1e-6):
        return rmsnorm_ref(x, scale, eps)

    def hold(fn, plain, err_ok, shape):
        def call(*a, **kw):
            before = {k: c.n for k, c in counters().items()}
            y = fn(*a, **kw)
            ran = {k: c.n - before[k] for k, c in counters().items()
                   if c.n > before[k]}
            err, ok = err_ok(y, plain(*a, **kw), *a)
            what = shape(*a)
            check(bool(torch.isfinite(y.float()).all()) and ok,
                  f"{fn.__name__} {what} ({sorted(ran)}) against its plain "
                  f"version: max err {err}")
            for k, n in ran.items():
                h = held.setdefault(k, {"launches": 0, "shapes": set(),
                                        "max_abs_err": 0.0})
                h["launches"] += n
                h["shapes"].add(what)
                h["max_abs_err"] = max(h["max_abs_err"], err)
            return y
        return call

    wraps = [
        (ops, "gpp_matmul", gpp_plain, gpp_err,
         lambda x, w, *_: f"{x.shape[0]}x{x.shape[1]}x{w.shape[1]} x "
                          f"{dt(x)} W {dt(w)}"),
        (ops, "paged_attention", pa_plain, pa_err,
         lambda q, a, *_: f"q {tuple(q.shape)} {dt(q)} pool "
                          f"{tuple(a.shape)}"),
        (rk, "rmsnorm", rms_plain, lambda y, ref, x, *_: rms_err(
            y, ref, dt(x)), lambda x, *_: f"{tuple(x.shape)} {dt(x)}")]
    saved = [(mod, name, getattr(mod, name)) for mod, name, *_ in wraps]
    try:
        for mod, name, plain, err_ok, shape in wraps:
            setattr(mod, name, hold(getattr(mod, name), plain, err_ok,
                                    shape))
        yield held
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def held_json(held: dict) -> dict:
    return {k: {**v, "shapes": sorted(v["shapes"])} for k, v in held.items()}


def check_held(what: str, run: dict) -> None:
    """Every launch of a run made under `held_to_plain` was held."""
    held = run["held"]
    check(all(held.get(k, {}).get("launches", 0) == n
              for k, n in run["launches"].items()),
          f"{what}: launches {run['launches']}, held "
          f"{ {k: v['launches'] for k, v in held.items()} }")
    print(f"{what}: every launch held against its plain version: "
          + "; ".join(f"{k} {v['launches']} launches at {len(v['shapes'])} "
                      f"shapes, max_abs_err {v['max_abs_err']:.3g}"
                      for k, v in sorted(held.items())), flush=True)


# run in a subprocess: one example's calls, the kernels' launch counts set
# to 0 before each and read after, a call with "held" under
# `held_to_plain`, one JSON line at the end
EXAMPLE_RUNNER = """
import contextlib, json, sys
sys.path[:0] = sys.argv[1:3]
import chip_smoke as cs
name, calls = sys.argv[3], json.loads(sys.argv[4])
ex = __import__(name)
out = []
for call in calls:
    counts = cs.counters()
    for c in counts.values():
        c.n = 0
    held = {}
    with (cs.held_to_plain(held) if call.get("held")
          else contextlib.nullcontext()):
        if name == "torch_train_e2e":
            res = ex.run(ex.parse_args(call["args"]))
        else:
            res = ex.run(**call["args"])
    out.append({"result": res, "held": cs.held_json(held),
                "launches": {k: c.n for k, c in counts.items()}})
print(json.dumps(out))
"""


def run_example(name: str, calls: list, cwd: str) -> list:
    """`examples/<name>.py`'s run() once a call ({"args": argv or keyword
    arguments, "held": whether under `held_to_plain`}), in a process of its
    own with `cwd` its working directory; its printout passed on, prefixed.
    Returns [{"result", "launches", "held"}] a call."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "examples")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run(
        [sys.executable, "-c", EXAMPLE_RUNNER, str(ROOT),
         str(ROOT / "examples"), name, json.dumps(calls)],
        capture_output=True, text=True, cwd=cwd, env=env,
        timeout=EXAMPLE_TIMEOUT_S[name])
    lines = proc.stdout.splitlines()
    for ln in lines[:-1]:
        print(f"  {name}: {ln}", flush=True)
    check(proc.returncode == 0, f"examples/{name}.py exited "
          f"{proc.returncode}: {proc.stderr[-3000:]}")
    return json.loads(lines[-1])


def _example_module(name: str):
    """`examples/<name>.py` imported in this process."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_example_routes(what: str, cfg, batch_size, seq):
    """The training example's model (random weights from seed 0, as the
    example draws them) on the first batch of its pipeline: one loss and
    gradient on the kernel route against the plain route, gated as
    `check_train_qwen` gates its bf16 routes (BF16_LOSS_RTOL, GRAD_COS)."""
    import torch
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.models import transformer as tf
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            "cuda")
    pipe = TokenPipeline(cfg, DataConfig(batch=batch_size, seq_len=seq))
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in pipe.batch_at(0).items()}
    ker, plain, counts = grad_routes(what, cfg, params, batch, TRAIN_PATH)
    res = compare_bf16_grads(what, ker, plain)
    res.update(launches=counts, loss=float(ker[0]),
               plain_loss=float(plain[0]))
    del ker, plain, params
    torch.cuda.empty_cache()
    return res


def check_examples(report):
    """The four examples of `examples/torch_*.py` on the card, each in a
    process of its own in a temporary working directory, the kernels built:
    the design space's printout equal to the JAX example's text; the
    quickstart (world size 1: 10 train steps on qwen1.5-0.5b SMOKE, 8 greedy
    tokens) with every launch held against its plain version
    (`held_to_plain`); the serve example's four rounds, its asserts holding
    (prefix hits, speculation == plain), its two obs files written, at most
    the three step shapes, and the paged engine on the kernels only; then
    the same four rounds again with every launch held, their streams the
    first run's; the training example at its default batch for
    EXAMPLE_STEPS of its 300 default steps (16 x 256 on the ~106M model,
    resident), its loss falling (its own assert), its seconds and tok/s;
    then `--stream-mode gpp` for EXAMPLE_GPP_STEPS steps, its 10 layers in
    pinned host memory, its losses resident's bit for bit; then a run
    saved at EXAMPLE_RESUME[0] steps and resumed to EXAMPLE_RESUME[1] (the
    resumed steps held), its losses the uninterrupted run's bit for bit;
    and, in this process, the ~106M model's loss and gradient on its first
    batch on the kernel route against the plain route
    (`check_example_routes`), the kernel route's loss the example's first.
    Each run's launches: the path's kernels only."""
    import torch
    from repro_torch.kernels.paged_attention import attention_route
    from repro_torch.models import registry
    card = report["card"]
    out = report["examples"] = {"card": card}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.run(
            [sys.executable, str(ROOT / "examples" /
                                 "torch_gpp_design_space.py")],
            capture_output=True, text=True, cwd=d, env=env, timeout=60)
        check(proc.returncode == 0 and proc.stdout == DESIGN_SPACE_TEXT,
              f"torch_gpp_design_space.py printed other text than the JAX "
              f"example (exit {proc.returncode}):\n{proc.stdout}"
              f"{proc.stderr[-2000:]}")
        out["design_space_s"] = time.perf_counter() - t
        print(f"examples [{card}]: torch_gpp_design_space.py == the JAX "
              f"example's text ({len(DESIGN_SPACE_TEXT.splitlines())} lines, "
              f"{out['design_space_s']:.1f} s)", flush=True)

        t = time.perf_counter()
        (qs,) = run_example("torch_quickstart",
                            [{"args": {"device": "cuda"}, "held": True}], d)
        r = qs["result"]
        vocab = registry.get_config("qwen1.5-0.5b", smoke=True).vocab_size
        check(len(r["losses"]) == 10 and all(math.isfinite(x)
                                             for x in r["losses"])
              and len(r["generated"]) == 9
              and all(0 <= x < vocab for x in r["generated"]),
              f"torch_quickstart.py: {r}")
        check_path_launches("torch_quickstart.py", qs["launches"],
                            TRAIN_PATH)
        check_held("torch_quickstart.py", qs)
        out["quickstart"] = {**r, "launches": qs["launches"],
                             "held": qs["held"],
                             "seconds": time.perf_counter() - t}

        t = time.perf_counter()
        sv, sv_held = run_example(
            "torch_serve_batched",
            [{"args": {"device": "cuda", "out_dir": d}},
             {"args": {"device": "cuda", "out_dir": d}, "held": True}], d)
        r = sv["result"]
        cfg = registry.get_config("qwen1.5-0.5b", smoke=True)
        attn = {"gqa_tc": "paged_attention_tc",
                "gqa": "paged_attention_bf16"}[attention_route(
                    torch.bfloat16, False, cfg.serve_block_size,
                    cfg.resolved_head_dim, 0)]
        path = ("gpp_matmul_tc", "gpp_matmul", attn, "paged_attention_merge",
                "rmsnorm")
        for what, x in (("", sv), (" (held)", sv_held)):
            check_path_launches(f"torch_serve_batched.py{what}",
                                x["launches"], path)
        check_held("torch_serve_batched.py", sv_held)
        check(sv_held["result"]["results"] == r["results"]
              and sv_held["result"]["spec"]["streams"]
              == r["spec"]["streams"],
              "torch_serve_batched.py: the held run's streams are not the "
              "first run's")
        check(all(set(c) <= {"prefill_chunk", "decode", "verify"}
                  and max(c.values()) <= 1
                  for c in r["trace_counts"].values()),
              f"torch_serve_batched.py: step shapes {r['trace_counts']}")
        check((Path(d) / "serve_trace.json").is_file()
              and (Path(d) / "serve_metrics.jsonl").is_file(),
              "torch_serve_batched.py wrote no trace or metrics file")
        out["serve"] = {**{k: r[k] for k in ("tokens", "seconds", "tok_s",
                                             "prefix", "obs",
                                             "trace_counts")},
                        "spec": {k: v for k, v in r["spec"].items()
                                 if k != "streams"},
                        "launches": sv["launches"], "held": sv_held["held"],
                        "wall_s": time.perf_counter() - t}
        print(f"examples [{card}]: torch_serve_batched.py (qwen1.5-0.5b "
              f"SMOKE widths): its asserts hold "
              f"(prefix hit_rate {r['prefix']['hit_rate']:.2f}, hit_tokens "
              f"{r['prefix']['hit_tokens']}; speculation == plain, "
              f"acceptance {r['spec']['acceptance_rate']:.2f}); batched "
              f"round {r['tokens']} tokens in {r['seconds']:.3f} s = "
              f"{r['tok_s']:.1f} tok/s; obs ttft_p50 "
              f"{r['obs']['ttft_p50_s'] * 1e3:.1f} ms, bw_utilization "
              f"measured {r['obs']['measured_bw_utilization']:.2f} vs "
              f"predicted {r['obs']['predicted_bw_utilization']:.2f}; "
              f"launches {sv['launches']}", flush=True)

        t = time.perf_counter()
        ck = Path(d) / "ckpt"
        a, b = EXAMPLE_RESUME
        runs = run_example("torch_train_e2e", [
            {"args": ["--steps", str(EXAMPLE_STEPS), "--ckpt-dir",
                      str(ck / "full")]},
            {"args": ["--steps", str(EXAMPLE_GPP_STEPS), "--stream-mode",
                      "gpp", "--ckpt-dir", str(ck / "gpp")]},
            {"args": ["--steps", str(a), "--ckpt-dir", str(ck / "resume")]},
            {"args": ["--steps", str(b), "--ckpt-dir", str(ck / "resume")],
             "held": True}], d)
        full, gpp, first, resumed = (x["result"] for x in runs)
        for what, x in zip(("resident", "gpp", "first", "resumed"), runs):
            check_path_launches(f"torch_train_e2e.py {what}",
                                x["launches"], TRAIN_PATH)
        check_held("torch_train_e2e.py resumed", runs[3])
        losses = full["losses"]
        check(len(losses) == EXAMPLE_STEPS and losses[-1] < losses[0]
              and full["checkpoint"] == EXAMPLE_STEPS,
              f"torch_train_e2e.py: {len(losses)} losses, "
              f"{losses[0]} -> {losses[-1]}, last checkpoint "
              f"{full['checkpoint']}")
        check(gpp["losses"] == losses[:EXAMPLE_GPP_STEPS],
              f"torch_train_e2e.py --stream-mode gpp: losses "
              f"{gpp['losses']} are not resident's "
              f"{losses[:EXAMPLE_GPP_STEPS]}")
        check(first["checkpoint"] == a and resumed["start"] == a
              and resumed["losses"] == losses[a:b],
              f"torch_train_e2e.py resumed at {resumed['start']}: losses "
              f"{resumed['losses']} against the straight run's "
              f"{losses[a:b]}")
        te = _example_module("torch_train_e2e")
        routes = check_example_routes("torch_train_e2e.py CONFIG_100M",
                                      te.CONFIG_100M, *EXAMPLE_BATCH)
        check(routes["loss"] == losses[0],
              f"torch_train_e2e.py: the kernel route's loss "
              f"{routes['loss']} on the first batch is not the example's "
              f"first {losses[0]}")
        out["train_e2e"] = {
            "params": full["params"], "steps": EXAMPLE_STEPS,
            "tokens_a_step": EXAMPLE_BATCH[0] * EXAMPLE_BATCH[1],
            "resident": {k: full[k] for k in ("seconds", "tok_s")},
            "first_loss": losses[0], "last_loss": losses[-1],
            "losses": losses,
            "gpp": {k: gpp[k] for k in ("seconds", "tok_s")},
            "gpp_steps": EXAMPLE_GPP_STEPS,
            "resume": {"saved_at": a, "resumed_to": b,
                       "losses": resumed["losses"]},
            "launches": {w: x["launches"] for w, x in
                         zip(("resident", "gpp", "first", "resumed"),
                             runs)},
            "held": runs[3]["held"], "routes": routes,
            "wall_s": time.perf_counter() - t}
        mparams = full["params"] / 1e6
        print(f"examples [{card}]: torch_train_e2e.py ({mparams:.1f}M "
              f"params, 16 x 256 tokens a step): resident "
              f"{EXAMPLE_STEPS} steps, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, {full['seconds']:.2f} s, "
              f"{full['tok_s']:.1f} tok/s; --stream-mode gpp (layers in "
              f"pinned host memory) {EXAMPLE_GPP_STEPS} steps bit for bit "
              f"resident's, {gpp['seconds']:.2f} s, {gpp['tok_s']:.1f} tok/s;"
              f" saved at {a} steps and resumed to {b}: losses bit for bit "
              f"the straight run's; kernel route vs plain on the first "
              f"batch: loss {routes['loss']:.6f} vs "
              f"{routes['plain_loss']:.6f}; launches (resident) "
              f"{runs[0]['launches']}", flush=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    global REPORT_DIR, H100_HBM_BYTES_PER_S
    ap = argparse.ArgumentParser()
    ap.add_argument("--json-out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}; "
              "run it from a checkout of the repo", file=sys.stderr)
        return 2
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.launch import roofline

    H100_HBM_BYTES_PER_S = roofline.HBM_BW
    PEAK_OPS["bfloat16"] = roofline.PEAK_FLOPS

    resolve_device("cuda")                  # also turns TF32 off
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    per = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f}s ({per})")
    report = {"card": smi, "build_s": build_s}
    if args.json_out:
        REPORT_DIR = Path(args.json_out).parent
        REPORT_DIR.mkdir(parents=True, exist_ok=True)

    phase_s = report["phase_s"] = {}

    def ph(name, fn, *a, **kw):
        """Run one phase and keep its seconds."""
        t = time.perf_counter()
        out = fn(*a, **kw)
        phase_s[name] = time.perf_counter() - t
        print(f"phase {name}: {phase_s[name]:.1f}s", flush=True)
        return out

    gpp_rows, gpp_err = ph("gpp", check_gpp, report)
    head_rows = ph("head", check_head, report)
    pa_rows = ph("paged", check_paged, report)
    rms_rows = ph("rmsnorm", check_rmsnorm, report)
    grouped_rows, grouped_err = ph("grouped", check_grouped, report)
    ph("moe deepseek", check_moe_layer, report, "deepseek-v2-lite-16b")
    mla_rows = ph("mla", check_mla, report)
    mla_block_rows = ph("mla blocks", check_mla_blocks, report)
    ph("mla split", mla_split_cost, report)
    kimi_grouped_rows = ph("grouped kimi", check_grouped_kimi, report)
    ph("moe kimi", check_moe_layer, report, "kimi-k2-1t-a32b")
    seq_rows = ph("gemm sequence", check_gemm_sequence, report)
    ph("prefix starts", check_prefix_starts, report)
    dense_rows, dense_err, dense_heads, dense_norms = ph(
        "dense gpp", check_dense_gpp, report)
    gqa_path = ("gpp_matmul_tc", "gpp_matmul", "paged_attention_tc",
                "paged_attention_merge", "rmsnorm")
    gqa_f32 = ("gpp_matmul", "paged_attention", "paged_attention_merge",
               "rmsnorm")
    # since slice 13, to leave the script room for its phases (the host
    # moved the whole run 20-35% between calls): qwen1.5-0.5b at 12 of its
    # 24 layers, deepseek-v2-lite-16b at 9 of its 27 in bf16 (the dense
    # layer and 8 MoE layers; 4 in f32 as before)
    qwen = ph("serve qwen", check_serving, report, "qwen1.5-0.5b", gqa_path,
              gqa_f32, bf16_layers=12, f32_layers=12,
              hooks={"prefix": prefix_serving, "obs": obs_run})
    deepseek = ph("serve deepseek", check_serving, report,
                  "deepseek-v2-lite-16b",
                             ("gpp_matmul_tc", "gpp_matmul",
                              "gpp_matmul_grouped_tc",
                              "paged_attention_mla_tc",
                              "paged_attention_merge", "rmsnorm"),
                             ("gpp_matmul", "gpp_matmul_grouped",
                              "paged_attention_mla", "paged_attention_merge",
                              "rmsnorm"),
                             f32_layers=4, bf16_layers=9,
                             hooks={"prefix": prefix_serving})
    blocks = ph("mla block sizes", check_mla_block_sizes, report)
    # slice 11: qwen2-7b (query group 7) and h2o-danube-1.8b (head_dim 80:
    # the FMA kernel's bf16 instance) at full width and depth, f32 too;
    # gemma3-12b at full width and depth in bf16, 12 layers in f32 (two
    # 5:1 superblocks; 48 in f32 is 47 GB), both also past its window;
    # kimi-k2 at full width with 2 of its 61 layers (the dense prefix layer
    # and one MoE layer of 384 experts: 1.03 T parameters fit no card)
    # (their spec on == off prompts: one token repeated,
    # `repeated_prompts`).  danube's 4096-token window does not bind under
    # max_len 128: its expiry is exercised at SMOKE on the CPU
    # (tests/test_torch_serving.py) and, on the card, by the same kernels
    # on gemma3's run past its window
    # since slice 13, to leave the script room for its phases: qwen2-7b
    # in f32 at 14 of its 28 layers, gemma3-12b in bf16 at 24 of its 48
    # (four 5:1 superblocks); since slice 16, when a slow host took the
    # script to 1,106 s of its 1,200, qwen2-7b in bf16 at 14 too; since
    # slice 17 (a slow host: 1,048 s), qwen2-7b at 8 in both dtypes and
    # gemma3-12b in bf16 at 12 (two superblocks)
    ph("serve qwen2", check_serving, report, "qwen2-7b", gqa_path, gqa_f32,
       f32_layers=8, bf16_layers=8, repeat=True,
       hooks={"draft": draft_run})
    ph("serve danube", check_serving, report, "h2o-danube-1.8b",
       ("gpp_matmul_tc", "gpp_matmul", "paged_attention_bf16",
        "paged_attention_merge", "rmsnorm"), gqa_f32, repeat=True)
    ph("serve gemma3", check_serving, report, "gemma3-12b", gqa_path,
       gqa_f32, f32_layers=12, bf16_layers=12,
       hooks={"long": window_long_run, "prefix": prefix_serving,
              "prefix_long": prefix_long_run}, repeat=True)
    ph("serve kimi", check_serving, report, "kimi-k2-1t-a32b",
                  ("gpp_matmul_tc", "gpp_matmul", "gpp_matmul_grouped_tc",
                   "paged_attention_tc", "paged_attention_merge", "rmsnorm"),
                  None, bf16_layers=2, repeat=True,
                  f32_note="2 layers in f32 are 80 GB; kimi-k2's f32 parity "
                           "with the reference stands on the CPU at SMOKE "
                           "(tests/test_torch_models.py, "
                           "test_torch_serving.py)")
    # slice 13: the dense-cache engine (zamba2, xlstm, and qwen1.5 under
    # --engine dense) and the step functions of the two embedding archs,
    # all at full width and depth; for the script's time, zamba2-2.7b at
    # 18 of its 54 layers (3 of its 9 6-layer superblocks; 30 in slice 16)
    # and xlstm-1.3b at 16 of its 48 (24 in slice 16), and qwen1.5-0.5b
    # under --engine dense at 12 of its 24, to make room for slice 17's
    # sharded runs
    for arch, layers in (("zamba2-2.7b", 18), ("xlstm-1.3b", 16)):
        ph(f"dense {arch}", check_dense_serving, report, arch,
           num_layers=layers)
    ph("dense qwen", check_dense_serving, report, "qwen1.5-0.5b",
       label="qwen1.5-0.5b --engine dense", num_layers=12)
    for arch in ("llama-3.2-vision-11b", "musicgen-large"):
        ph(f"steps {arch}", check_step_model, report, arch)
    # slice 14: training, its kernels at the training shapes, then qwen1.5
    # at full width and depth and deepseek at full width with 2 layers
    train_rows, train_norms = ph("train kernels", check_train_kernels,
                                 report)
    ph("train qwen", check_train_qwen, report)
    ph("train deepseek", check_train_deepseek, report)
    # slice 15: the layer streamer, qwen1.5-0.5b's 24 layers from pinned
    # host memory
    streaming = ph("layer streaming", check_layer_streaming, report)
    # slice 16: the sharded steps on a 1x1 NCCL mesh
    sharded = ph("sharded steps", check_sharded_steps, report)
    # slice 18: the dry run and the roofline against the steps just timed
    ph("roofline", check_roofline, report)
    # slice 20: the four examples, each in a process of its own
    examples = ph("examples", check_examples, report)
    shard_key = "sharded steps (1x1 NCCL mesh)"
    shard_n = sharded["launches"]

    g = next(r for r in gpp_rows if r["path"] == "qwen1.5-0.5b"
             and r["phase"] == "decode" and r["proj"] == "gate_up"
             and r["dtype"] == "bfloat16")
    gr = next(r for r in gpp_rows if r["proj"] == "router"
              and r["phase"] == "decode")
    p = next(r for r in pa_rows if r["case"] == "decode"
             and r["dtype"] == "bfloat16" and r["head_dim"] == HD)
    pf = next(r for r in pa_rows if r["case"] == "decode"
              and r["dtype"] == "float32")
    pb = next(r for r in pa_rows if r["case"] == "h2o-danube-1.8b decode"
              and r["dtype"] == "bfloat16")
    at_new = ("ms", "plain_ms", "library_ms", "bound_ms", "max_abs_err")
    pa_new = {f"{r['case']} {r['dtype']} {r['heads']}/{r['kv_heads']}x"
              f"{r['head_dim']} window {r['window']}":
              {k: r[k] for k in at_new} for r in pa_rows
              if r["case"].split()[0] in NEW_ARCHS and "ms" in r}
    gpp_new = {f"{r['path']} {r['proj']} {r['M']}x{r['K']}x{r['N']} "
               f"{r['dtype']}": {k: r[k] for k in at_new}
               for r in gpp_rows if r["path"] in NEW_ARCHS and "ms" in r}
    seq = {f"M={r['M']} G={r['G']}{' planned' if r['planned'] else ''}":
           {k: r[k] for k in ("ms", "call_ms", "achieved_share")}
           for r in seq_rows}
    rq = next(r for r in rms_rows if r["width"] == D
              and r["dtype"] == "bfloat16")
    gg = next(r for r in grouped_rows if r["phase"] == "decode"
              and r["proj"] == "gate_up" and r["dtype"] == "bfloat16")
    gf = next(r for r in grouped_rows if r["phase"] == "decode"
              and r["proj"] == "gate_up" and r["dtype"] == "float32")
    m = next(r for r in mla_rows if r["case"] == "decode"
             and r["dtype"] == "bfloat16")
    mf = next(r for r in mla_rows if r["case"] == "decode"
              and r["dtype"] == "float32")
    mla_bf16_rows = [r for r in mla_block_rows if r["dtype"] == "bfloat16"]
    mb8 = next(r for r in mla_bf16_rows if r["case"] == "decode"
               and r["block_size"] == 8)
    mla_decode = {f"{r['dtype']} block {r['block_size']}": {
        k: r[k] for k in ("ms", "kernel_ms", "merge_ms", "graph_ms",
                          "plain_ms", "library_ms", "bound_ms", "plan")}
        for r in mla_rows + mla_block_rows
        if r["case"] == "decode" and r["route"] == "mla"}
    mm = mla_merge_time(m)
    mm32 = mla_merge_time(mf, "float32")
    report["paged_attention_merge"] = {"bfloat16": mm, "float32": mm32}
    for dt, r in (("bf16", mm), ("f32", mm32)):
        print(f"paged_attention_merge {dt} MLA decode (kv_splits "
              f"{r['kv_splits']}): ms={r['ms']:.4f} plain_ms="
              f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} "
              f"({r['bound_by']}) wall_ms={r['wall_ms']:.4f}")
    numbers = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    serving = report["serving"]
    example_launches = {
        "examples/torch_quickstart.py": examples["quickstart"]["launches"],
        "examples/torch_serve_batched.py": examples["serve"]["launches"],
        "examples/torch_train_e2e.py": {
            k: sum(r[k] for r in examples["train_e2e"]["launches"].values())
            for k in examples["quickstart"]["launches"]}}

    def by_path(counter, f32=False):
        """{path: launches of `counter`} over every served path that ran
        it: the bf16 runs (and gemma3's long run) or the f32 kernel runs."""
        keys = (("f32_kernel", " in f32 ({} layers)"),
                ("long_f32", " past its window in f32 ({} layers)"),
                ("prefix_f32", " prefix cache in f32 ({} layers)")) if f32 \
            else (("bf16", ""), ("long_bf16", " past its window"),
                  ("prefix_bf16", " prefix cache"),
                  ("prefix_long_bf16", " shared prefix past its window"),
                  ("obs_bf16", " obs"), ("draft_bf16", " draft model"))
        out = {}
        for arch, runs in serving.items():
            for key, label in keys:
                n = runs.get(key, {}).get("launches", {}).get(counter, 0)
                if n:
                    layers = runs.get("f32_kernel", runs["bf16"])[
                        "num_layers"]
                    out[arch + label.format(layers)] = n
        if not f32:                  # the examples run in bf16
            for what, n in example_launches.items():
                if n.get(counter):
                    out[what] = n[counter]
        return out

    def train_by(kernel):
        """The training-shape times of one kernel, by projection."""
        return {f"{r['proj']} " + "x".join(str(r[k]) for k in
                                           ("E", "M", "K", "N") if k in r):
                {k: r[k] for k in at_new if k in r}
                for r in train_rows if r["kernel"] == kernel}

    def train_err(kernel):
        return max(r["max_abs_err"] for r in train_rows
                   if r["kernel"] == kernel)

    stream_key = "qwen1.5-0.5b layer streaming (24 layers from host memory)"
    tc_by_path = {**by_path("gpp_matmul_tc"),
                  stream_key: streaming["launches"]["gpp_matmul_tc"],
                  shard_key: shard_n["gpp_matmul_tc"]}
    fma_by_path = {**by_path("gpp_matmul"), **by_path("gpp_matmul", True),
                   stream_key: streaming["launches"]["gpp_matmul"],
                   shard_key: shard_n["gpp_matmul"],
                   shard_key + " f32": shard_n["gpp_matmul f32"]}
    rms_by_path = {**by_path("rmsnorm"),
                   stream_key: streaming["launches"]["rmsnorm"],
                   shard_key: shard_n["rmsnorm"],
                   shard_key + " f32": shard_n["rmsnorm f32"]}
    grouped_by_path = {**by_path("gpp_matmul_grouped_tc"),
                       shard_key: shard_n["gpp_matmul_grouped_tc"]}
    head_by_shape = {f"{r['arch']} {r['phase']} {r['M']}x{r['K']}x{r['N']}":
                     {k: r[k] for k in ("ms", "library_ms", "plain_ms",
                                        "bound_ms")}
                     for r in head_rows}
    grouped_fma_by_shape = {
        f"{r['phase']} {r['proj']} {r['E']}x{r['M']}x{r['K']}x{r['N']}":
            {k: r[k] for k in ("ms", "library_ms", "plain_ms", "bound_ms",
                               "plan", "ctas_per_sm")}
        for r in grouped_rows if r["dtype"] == "float32"}
    kernels = [
        {"name": "gpp_matmul_tc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gpp_matmul.cu",
         "replaces": "src/repro/kernels/gpp_matmul.py:408",
         "kernel": "gpp_matmul_tc_kernel (bf16 x and W; cluster split-K, "
                   "partials summed in rank order through distributed "
                   "shared memory)",
         "path": ", ".join(serving),
         "launches": sum(tc_by_path.values()),
         "launches_by_path": tc_by_path,
         "max_abs_err": max(gpp_err["tc"], dense_err["tc"],
                            train_err("gpp_matmul_tc")),
         "tol": "atol 2e-2 + rtol 2e-2 x |plain| (bf16)",
         "shape": f"qwen decode up-projection {g['M']}x{g['K']}x{g['N']} "
                  "bf16 (every shape of both paths: --json-out)",
         "fma_ms": g["fma_ms"],
         "slice11_decode_shapes": gpp_new,
         "slice13_decode_shapes": {
             f"{r['path']} {r['proj']} {r['M']}x{r['K']}x{r['N']}":
                 {k: r[k] for k in at_new} for r in dense_rows if "ms" in r},
         "gemm_sequence": seq,
         "train_shapes": train_by("gpp_matmul_tc"),
         "layer_streaming_ms": {
             shape: {mode: r["ms"] for mode, r in row.items()
                     if isinstance(r, dict) and "ms" in r}
             for shape, row in streaming["shapes"].items()},
         "worst_prefill_verify_vs_library": max(
             (r["ms"] / r["library_ms"], f"{r['path']} {r['phase']} "
              f"{r['proj']} {r['M']}x{r['K']}x{r['N']}")
             for r in gpp_rows if r["dtype"] == "bfloat16"
             and r["phase"] != "decode" and "ms" in r),
         **{k: g[k] for k in numbers}},
        {"name": "gpp_matmul", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gpp_matmul.cuh",
         "replaces": "src/repro/kernels/gpp_matmul.py:408",
         "kernel": "gpp_matmul_kernel (f32 x, or f32 / int8 W; the split-K "
                   "FMA body of gpp_matmul.cuh at E = 1, split tiles "
                   "summed by their last CTA)",
         "path": "every served path (its f32 logits head; the MoE "
                 "models' f32 router); f32 runs",
         "launches": sum(by_path("gpp_matmul").values())
         + streaming["launches"]["gpp_matmul"],
         "launches_by_path": fma_by_path,
         "max_abs_err": max(gpp_err["fma"], dense_err["fma"],
                            max(r["max_abs_err"] for r in head_rows),
                            train_err("gpp_matmul")),
         "tol": "atol 2e-4 + rtol 2e-4 x |plain| (f32); bf16 and int8 W as "
                "bf16",
         "shape": f"deepseek decode router {gr['M']}x{gr['K']}x{gr['N']} "
                  "f32 (prefill / verify, every f32 decode shape and the "
                  "heads: --json-out)",
         "graph_ms": gr["graph_ms"],
         "library_graph_ms": gr["library_graph_ms"],
         "router_ms_by_phase": {r["phase"]: r["ms"] for r in gpp_rows
                                if r["proj"] == "router"
                                and r["path"] == "deepseek-v2-lite-16b"},
         "logits_head": head_by_shape,
         "train_head": train_by("gpp_matmul"),
         "slice13_heads": {f"{a} {SLOTS}x{k}x{n}": {
             x: dense_heads[a][x] for x in ("ms", "library_ms", "plain_ms",
                                            "bound_ms")}
             for a, (k, n) in DENSE_HEADS.items()},
         **{k: gr[k] for k in numbers}},
        {"name": "paged_attention_tc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341",
         "kernel": "paged_attention_tc_kernel (bf16 GQA / window, split-KV "
                   "over fixed block runs; ms includes its merge kernel's)",
         "path": ", ".join(by_path("paged_attention_tc")),
         "launches": sum(by_path("paged_attention_tc").values()),
         "launches_by_path": by_path("paged_attention_tc"),
         "max_abs_err": max(r["max_abs_err"] for r in pa_rows
                            if r["route"] == "gqa_tc"),
         "tol": "atol 2e-2 (bf16); decode / prefill / verify, window 32 or "
                "none, head_dim 64 / 128 / 256",
         "shape": f"decode B={SLOTS} H={H} hd={HD} positions "
                  f"{p['positions']} bf16",
         "fma_ms": p["fma_ms"],
         "slice11_shapes": {k: v for k, v in pa_new.items()
                            if "bfloat16" in k},
         **{k: p[k] for k in numbers}},
        {"name": "paged_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341",
         "kernel": "paged_attention_kernel (f32 GQA / window, FMA, "
                   "split-KV over fixed runs of pieces; ms includes its "
                   "merge kernel's)",
         "path": ", ".join(by_path("paged_attention", True)),
         "launches": sum(by_path("paged_attention", True).values()),
         "launches_by_path": by_path("paged_attention", True),
         "max_abs_err": max(r["max_abs_err"] for r in pa_rows
                            if r["route"] == "gqa"),
         "shape": f"decode B={SLOTS} H={H} hd={HD} positions "
                  f"{pf['positions']} f32",
         **{k: pf[k] for k in ("kernel_ms", "merge_ms", "graph_ms",
                               "plan")},
         **{k: pf[k] for k in numbers}},
        {"name": "paged_attention_bf16", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341",
         "kernel": "paged_attention_kernel, bf16 instance (FMA, split-KV "
                   "over fixed runs of pieces; bf16 GQA at head dims the "
                   "tensor-core kernel does not take; ms includes its "
                   "merge kernel's)",
         "path": ", ".join(by_path("paged_attention_bf16")),
         "launches": sum(by_path("paged_attention_bf16").values()),
         "launches_by_path": by_path("paged_attention_bf16"),
         "max_abs_err": max(r["max_abs_err"] for r in pa_rows
                            if r["route"] == "gqa"
                            and r["dtype"] == "bfloat16"),
         "tol": "atol 2e-2 (bf16); decode / prefill / verify, window 4096 "
                "and 32",
         "shape": f"danube decode B={pb['B']} H={pb['heads']} kv "
                  f"{pb['kv_heads']} hd={pb['head_dim']} positions "
                  f"{pb['positions']} bf16",
         **{k: pb[k] for k in ("kernel_ms", "merge_ms", "graph_ms",
                               "plan")},
         **{k: pb[k] for k in numbers}},
        {"name": "rmsnorm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rmsnorm.cu",
         "replaces": "none: a kernel of the port alone (the reference's "
                     "RMSNorm, src/repro/models/layers.py:60, is XLA's)",
         "kernel": "rmsnorm_kernel (row-invariant: a CTA a row, threads "
                   "from the width)",
         "path": ", ".join(serving),
         "launches": sum(rms_by_path.values()),
         "launches_by_path": rms_by_path,
         "max_abs_err": max([r["max_abs_err"] for r in rms_rows
                             + dense_norms] + list(train_norms.values())),
         "train_shapes_max_abs_err": train_norms,
         "tol": "f32 1e-5 + 1e-5 x |plain|; bf16 one bf16 step (also the "
                "cross layers' 128-wide per-head rows)",
         "shape": f"qwen decode {SLOTS}x{D} bf16 (widths 512-2048, 1-32 "
                  "rows: --json-out)",
         **{k: rq[k] for k in numbers}},
        {"name": "gpp_matmul_grouped", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gpp_matmul_grouped.cu",
         "replaces": "src/repro/kernels/gpp_matmul.py:606",
         "kernel": "gpp_matmul_grouped_tc_kernel (bf16 x and W)",
         "path": ", ".join(by_path("gpp_matmul_grouped_tc")),
         "launches": sum(grouped_by_path.values()),
         "launches_by_path": grouped_by_path,
         "kimi_by_shape": {
             f"{r['phase']} {r['proj']} {r['E']}x{r['M']}x{r['K']}x{r['N']}":
                 {k: r[k] for k in ("ms", "library_ms", "plain_ms",
                                    "bound_ms", "max_abs_err")}
             for r in kimi_grouped_rows},
         "expert_bytes_unrouted_share": {
             arch: {ph: v["expert_bytes_unrouted_share"]
                    for ph, v in out.items() if ph != "peak_mem_gb"}
             for arch, out in report["moe_layer"].items()},
         "max_abs_err": max(grouped_err["tc"],
                            train_err("gpp_matmul_grouped_tc")),
         "train_capacity": train_by("gpp_matmul_grouped_tc"),
         "shape": f"decode gate/up {gg['E']}x{gg['M']}x{gg['K']}x{gg['N']} "
                  "bf16",
         **{k: gg[k] for k in numbers}},
        {"name": "gpp_matmul_grouped_fma", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gpp_matmul.cuh",
         "replaces": "src/repro/kernels/gpp_matmul.py:606",
         "kernel": "gpp_matmul_grouped_kernel (f32 x, or f32 / int8 W; the "
                   "split-K FMA body of gpp_matmul.cuh over the expert "
                   "axis)",
         "path": "deepseek-v2-lite-16b in f32 "
                 f"({deepseek['f32_kernel']['num_layers']} layers); "
                 f"{shard_key} f32",
         "launches":
             deepseek["f32_kernel"]["launches"]["gpp_matmul_grouped"]
             + shard_n["gpp_matmul_grouped f32"],
         "launches_by_path": {
             "deepseek-v2-lite-16b in f32": deepseek["f32_kernel"][
                 "launches"]["gpp_matmul_grouped"],
             shard_key + " f32": shard_n["gpp_matmul_grouped f32"]},
         "max_abs_err": grouped_err["fma"],
         "tol": "atol 2e-4 + rtol 2e-4 x |plain| (f32); bf16 x as bf16",
         "shape": f"decode gate/up {gf['E']}x{gf['M']}x{gf['K']}x{gf['N']} "
                  "f32 (library: torch.bmm, TF32 off)",
         "by_shape": grouped_fma_by_shape,
         **{k: gf[k] for k in numbers}},
        {"name": "paged_attention_mla_tc", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341 (mla=True, "
                     ":173-177)",
         "kernel": "paged_attention_mla_tc_kernel (bf16, split-KV; ms "
                   "includes its merge kernel's)",
         "path": "deepseek-v2-lite-16b",
         "launches": deepseek["bf16"]["launches"]["paged_attention_mla_tc"],
         "max_abs_err": max(r["max_abs_err"] for r in mla_rows
                            if r["dtype"] == "bfloat16"),
         "shape": f"decode B={SLOTS} H={DS_H} latent {DS_R}+{DS_RR} "
                  f"positions {m['positions']} bf16",
         **{k: m[k] for k in numbers}},
        {"name": "paged_attention_merge", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341 (the split "
                     "walks' merge, for mla=True and GQA)",
         "kernel": "paged_attention_merge_kernel (f32 partials -> bf16)",
         "path": ", ".join(serving),
         "launches": sum(by_path("paged_attention_merge").values()),
         "launches_by_path": by_path("paged_attention_merge"),
         "max_abs_err": max(r["merge_max_abs_err"] for r in mla_rows + pa_rows
                            if "merge_max_abs_err" in r),
         "shape": f"MLA decode B={SLOTS} H={DS_H} latent {DS_R}, "
                  f"{mm['kv_splits']} partials a row (alone; its time is "
                  "also inside paged_attention_mla_tc's and, as "
                  "gqa_merge_ms, paged_attention_tc's)",
         "gqa_merge_ms": p["merge_ms"],
         **{k: mm[k] for k in numbers}},
        {"name": "paged_attention_merge_f32", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341 (the split "
                     "walks' merge, for mla=True and GQA)",
         "kernel": "paged_attention_merge_kernel, f32 instance (f32 "
                   "partials -> f32, after the FMA kernels in f32)",
         "path": "every f32 run",
         "launches": sum(by_path("paged_attention_merge", True).values()),
         "launches_by_path": {
             **by_path("paged_attention_merge", True),
             **{f"deepseek-v2-lite-16b (4 layers) {k}":
                v["launches"]["paged_attention_merge"]
                for k, v in blocks.items() if k.startswith("float32")}},
         "max_abs_err": max(r["max_abs_err"] for r in mla_rows + pa_rows
                            if r["dtype"] == "float32"),
         "tol": "inside the FMA kernels' f32 rows (atol 2e-4)",
         "shape": f"MLA decode B={SLOTS} H={DS_H} latent {DS_R}, "
                  f"{mm32['kv_splits']} partials a row (alone; its time is "
                  "also inside paged_attention_mla's and "
                  "paged_attention's)",
         **{k: mm32[k] for k in numbers}},
        {"name": "paged_attention_mla", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341 (mla=True, "
                     ":173-177)",
         "kernel": "paged_attention_mla_kernel (f32, FMA, split-KV over "
                   "fixed runs of pieces; ms includes its merge kernel's)",
         "path": "deepseek-v2-lite-16b in f32 "
                 f"({deepseek['f32_kernel']['num_layers']} layers; also at "
                 "8- and 128-token blocks)",
         "launches": deepseek["f32_kernel"]["launches"]["paged_attention_mla"],
         "launches_by_block": {
             k: v["launches"]["paged_attention_mla"]
             for k, v in blocks.items() if k.startswith("float32")},
         "max_abs_err": max(r["max_abs_err"] for r in mla_rows
                            + mla_block_rows if r["dtype"] == "float32"),
         "tol": "atol 2e-4 (f32), decode / prefill / verify at blocks of "
                "16, 128 and 256",
         "shape": f"decode B={SLOTS} H={DS_H} latent {DS_R}+{DS_RR} "
                  f"positions {mf['positions']} f32, 16-token blocks",
         "decode_by_block": mla_decode,
         **{k: mf[k] for k in ("kernel_ms", "merge_ms", "graph_ms",
                               "plan")},
         **{k: mf[k] for k in numbers}},
        {"name": "paged_attention_mla_bf16", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
         "replaces": "src/repro/kernels/paged_attention.py:341 (mla=True, "
                     ":173-177)",
         "kernel": "paged_attention_mla_kernel, bf16 instance (FMA; bf16 "
                   "MLA at block sizes the tensor-core kernel does not "
                   "take)",
         "path": "deepseek-v2-lite-16b (4 layers) at 8- and 128-token KV "
                 "blocks (ms includes its merge kernel's)",
         "launches": sum(v["launches"]["paged_attention_mla_bf16"]
                         for k, v in blocks.items()
                         if k.startswith("bfloat16")),
         "launches_by_block": {
             k: v["launches"]["paged_attention_mla_bf16"]
             for k, v in blocks.items() if k.startswith("bfloat16")},
         "max_abs_err": max(r["max_abs_err"] for r in mla_bf16_rows),
         "tol": "atol 2e-2 (bf16), decode / prefill / verify at blocks of "
                "8, 128 and 256",
         "shape": f"decode B={SLOTS} H={DS_H} latent {DS_R}+{DS_RR} "
                  f"positions {mb8['positions']} bf16, 8-token blocks",
         **{k: mb8[k] for k in ("kernel_ms", "merge_ms", "graph_ms",
                                "plan")},
         **{k: mb8[k] for k in numbers}},
    ]
    report["kernels"] = kernels
    if args.json_out:
        out = Path(args.json_out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
