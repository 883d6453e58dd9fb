"""Training CLI: the port's copy of `repro.launch.train`, at world size 1.

  python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 100 \\
      --batch 8 --seq 128 --ckpt-dir /path/to/ckpts
  python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \\
      --device cpu --steps 20 --batch 4 --seq 32

runs on CUDA; `--device cpu` runs the plain PyTorch path on the CPU.
Without CUDA and without `--device cpu` it raises.  Flags are the
reference CLI's plus `--device`; `--stream-mode` takes the four modes of
the layer streamer (`core.streamer`; at world size 1 every leaf is whole
on the device, so only gpp's ring copies), `--devices` 0 or 1 and `--mesh`
only a one-device layout (`auto`, `1x1`): meshes come with the sharded
steps (ROADMAP §1.8b), and anything else raises.

Fault tolerance in the loop, as in the reference: deterministic data
(seed, step), async atomic checkpoints every --ckpt-every steps, resume
from the latest committed step, a straggler watchdog on step wall times.
A checkpoint is labelled with the number of steps it has taken, so a
resumed run starts at the first step not yet taken (the reference labels
its mid-run checkpoints one step early; ROADMAP §3.6).  `--lr` is the
peak of the cosine schedule (the reference parses it and runs its
default, the same 3e-4).  `main(argv)` returns the losses.
"""
from __future__ import annotations

import argparse
import collections
import statistics
import time

DISTRIBUTION = "comes with the sharded steps (ROADMAP §1.8b)"


class StepWatchdog:
    """record(dt) -> True when a step straggles past `factor` x the median
    of the last `window` steps (the reference's inline fallback)."""

    def __init__(self, factor: float = 3.0, window: int = 256):
        self.factor = factor
        self._times = collections.deque(maxlen=window)

    @property
    def median(self) -> float:
        return statistics.median(self._times) if self._times else 0.0

    def record(self, dt: float) -> bool:
        straggled = len(self._times) >= 3 and dt > self.factor * self.median
        self._times.append(dt)
        return straggled


def _check_one_device(args) -> None:
    if args.devices not in (0, 1):
        raise ValueError(f"--devices {args.devices}: more than one device "
                         f"{DISTRIBUTION}")
    if args.mesh not in ("auto", "1x1"):
        raise ValueError(f"--mesh {args.mesh}: a mesh {DISTRIBUTION}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="global batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4,
                    help="peak of the cosine schedule (the reference CLI "
                         "parses it and runs its default, the same 3e-4)")
    ap.add_argument("--devices", type=int, default=0,
                    help="devices to run on: 0 (as-is) or 1")
    ap.add_argument("--mesh", default="auto",
                    help="'auto' or '1x1' (one device)")
    ap.add_argument("--stream-mode", default=None,
                    choices=["resident", "insitu", "naive_pp", "gpp"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50,
                    help="checkpoint every N steps, labelled with the steps "
                         "taken; the reference CLI labels its mid-run "
                         "checkpoints one step early, so resuming one of "
                         "those here takes its last step again")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    _check_one_device(args)

    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.streamer import StreamSettings
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adafactor as adaf
    from repro_torch.optim import adamw as adam

    dev = resolve_device(args.device)
    cfg = registry.get_config(args.arch, smoke=args.smoke)
    if args.stream_mode:
        cfg = cfg.with_(stream=StreamSettings(
            mode=args.stream_mode, ring_depth=cfg.stream.ring_depth))
    print(f"device: {dev} (world size 1)")

    bundle = make_train_step(cfg, adam.AdamWConfig(lr=args.lr))
    params = tf.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    opt_state = (adaf.adafactor_init(params) if cfg.optimizer == "adafactor"
                 else adam.adamw_init(params))

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if mgr.latest_step() is not None:
            state, start_step = mgr.restore(
                {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            print(f"resumed from step {start_step}")

    pipe = TokenPipeline(cfg, DataConfig(
        seed=1234, batch=args.batch, seq_len=args.seq)).start(start_step)
    watchdog = StepWatchdog()
    losses = []
    try:
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(pipe).items()}
            t0 = time.time()
            params, opt_state, metrics = bundle.fn(params, opt_state, batch,
                                                   step)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            losses.append(loss)
            if watchdog.record(dt):
                print(f"[watchdog] step {step} straggled: {dt:.2f}s "
                      f"(median {watchdog.median:.2f}s)")
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):8.3f} "
                      f"{dt * 1e3:7.1f} ms")
            done = step + 1
            if mgr and done < args.steps and done % args.ckpt_every == 0:
                mgr.save(done, {"params": params, "opt": opt_state},
                         blocking=False)
    finally:
        pipe.stop()
        if mgr:
            mgr.wait()

    if mgr:
        mgr.save(args.steps, {"params": params, "opt": opt_state})
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
