"""Training CLI: the port's copy of `repro.launch.train`.

  python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 100 \\
      --batch 8 --seq 128 --ckpt-dir /path/to/ckpts
  python -m repro_torch.launch.train --arch qwen1.5-0.5b --smoke \\
      --device cpu --steps 20 --batch 4 --seq 32 --devices 4 --mesh 2x2

runs on CUDA; `--device cpu` runs the plain PyTorch path on the CPU.
Without CUDA and without `--device cpu` it raises.  Flags are the
reference CLI's plus `--device`; `--stream-mode` takes the four modes of
the layer streamer (`core.streamer`); at world size 1 on CUDA a streamed
mode keeps the layers in pinned host memory
(`launch.steps.streams_from_host`).  `--devices N` with `--mesh DxM`
(or `auto`: D = N // 2, as the reference) trains on a ("data", "model")
mesh of N ranks (`launch.steps.make_train_step` on the mesh): with
`--device cpu` N gloo ranks in new processes, with CUDA one rank a card
over NCCL (more ranks than cards raises).  Each dp rank takes its rows of
the single-host global batch, so a 2x2 run sees the batches of a run on
one device; rank 0 prints and writes the checkpoints (whole leaves,
`CheckpointManager.save(specs=)`), and every rank restores its pieces.
`--devices` 0 or 1 with `--mesh` auto or 1x1 runs the mesh-less step in
this process (world size 1).

Fault tolerance in the loop, as in the reference: deterministic data
(seed, step), async atomic checkpoints every --ckpt-every steps, resume
from the latest committed step, a straggler watchdog on step wall times.
A checkpoint is labelled with the number of steps it has taken, so a
resumed run starts at the first step not yet taken (the reference labels
its mid-run checkpoints one step early: ROADMAP §3, known fault 3).
`--lr` is the peak of the cosine schedule (the reference parses it and
runs its default, the same 3e-4).  `main(argv)` returns the losses (of
rank 0, in this process; a run of spawned ranks prints them and returns
None).
"""
from __future__ import annotations

import argparse
import collections
import statistics
import time

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


def _mesh_shape(args) -> "tuple[int, int] | None":
    """(data, model) of the mesh the flags ask for; None: no mesh (world
    size 1 in this process)."""
    n = args.devices
    if args.mesh == "production":
        if args.device == "cpu":
            raise ValueError("--mesh production is 16 x 16 cards over NCCL")
        return 16, 16
    if args.mesh == "auto":
        if n <= 1:
            return None
        d = max(1, n // 2)
        return d, n // d
    d, m = (int(v) for v in args.mesh.lower().split("x"))
    if n and d * m != n:
        raise ValueError(f"--mesh {args.mesh} is not {n} devices")
    if d * m == 1:
        return None
    return d, m


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
                    help="ranks to train on (0: one, in this process)")
    ap.add_argument("--mesh", default="auto",
                    help="'auto' | 'DxM' e.g. 2x2 (data x model) | "
                         "'production' (16x16 cards)")
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
    shape = _mesh_shape(args)
    if shape is None:
        return _train(args, 0, 1, None)
    from repro_torch.launch.mesh import spawn_ranks
    n = shape[0] * shape[1]
    backend = "gloo" if args.device == "cpu" else "nccl"
    if backend == "nccl":
        import torch
        if not torch.cuda.is_available() or n > torch.cuda.device_count():
            raise RuntimeError(
                f"--devices {n} over NCCL needs {n} cards; have "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    spawn_ranks(_train_rank, n, args, shape, backend=backend,
                threads=1 if backend == "gloo" else 0)
    return None


def _train_rank(rank: int, world: int, args, shape) -> None:
    from repro_torch.launch.mesh import make_cuda_mesh, make_host_mesh
    mesh = (make_host_mesh(*shape) if args.device == "cpu"
            else make_cuda_mesh(*shape))
    _train(args, rank, world, mesh)


def _train(args, rank: int, world: int, mesh):
    """The loop on one rank (`mesh` None: the mesh-less step)."""
    import torch

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.streamer import StreamSettings
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.dist.sharding import axis_sizes, shard_tree
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
    say = print if rank == 0 else (lambda *a, **k: None)
    optc = adam.AdamWConfig(lr=args.lr)
    if mesh is None:
        say(f"device: {dev} (world size 1)")
        bundle = make_train_step(cfg, optc=optc)
        specs = None
    else:
        say(f"mesh: {axis_sizes(mesh)}  ranks: {world}  device: {dev}")
        bundle = make_train_step(
            cfg, mesh, ShapeConfig("cli", args.seq, args.batch, "train"),
            optc)
        specs = {"params": bundle.arg_specs[0], "opt": bundle.arg_specs[1]}
    params = tf.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    # from the whole leaves: Adafactor's factors are whole on every rank
    opt_state = (adaf.adafactor_init(params) if cfg.optimizer == "adafactor"
                 else adam.adamw_init(params))
    if specs is not None:
        params = shard_tree(params, specs["params"], mesh)
        opt_state = shard_tree(opt_state, specs["opt"], mesh)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir)
        if mgr.latest_step() is not None:
            state, start_step = mgr.restore(
                {"params": params, "opt": opt_state}, shardings=specs,
                mesh=mesh)
            params, opt_state = state["params"], state["opt"]
            say(f"resumed from step {start_step}")

    pipe = TokenPipeline(cfg, DataConfig(
        seed=1234, batch=args.batch, seq_len=args.seq)).start(start_step)
    watchdog = StepWatchdog()
    losses = []
    try:
        for step in range(start_step, args.steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(pipe).items()}
            if specs is not None:
                batch = shard_tree(batch, bundle.arg_specs[2], mesh)
            t0 = time.time()
            params, opt_state, metrics = bundle.fn(params, opt_state, batch,
                                                   step)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            losses.append(loss)
            if watchdog.record(dt):
                say(f"[watchdog] step {step} straggled: {dt:.2f}s "
                      f"(median {watchdog.median:.2f}s)")
            if step % args.log_every == 0:
                say(f"step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):8.3f} "
                      f"{dt * 1e3:7.1f} ms")
            done = step + 1
            if mgr and done < args.steps and done % args.ckpt_every == 0:
                mgr.save(done, {"params": params, "opt": opt_state},
                         blocking=False, specs=specs, mesh=mesh)
    finally:
        pipe.stop()
        if mgr:
            mgr.wait()

    if mgr:
        mgr.save(args.steps, {"params": params, "opt": opt_state},
                 specs=specs, mesh=mesh)
    if losses:
        say(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
