"""The port's training loop against the JAX package on the CPU: the
micro-train of `tests/test_system.py` (qwen1.5-0.5b SMOKE, batches of the
token pipeline, AdamW at lr 1e-3) at float32, 8 steps of both from the
same numpy-seeded parameters and the same batches, each loss within 1e-4
relative, the loss descending; then a checkpoint saved, restored and a
step taken from each state with equal losses.  The train step of
`launch.steps` against the reference's composition (loss and gradient,
`cosine_lr(step, peak, 200, 10_000)`, AdamW or Adafactor).  The CLI with
`--device cpu --smoke`: checkpoints, resume from the latest committed
step (also from a mid-run checkpoint, to the losses of an uninterrupted
run), its checkpoint labels beside the reference CLI's (one step apart
mid-run), its refusal of a mesh without the cards for it, and
`--stream-mode`
insitu / naive_pp / gpp giving resident's losses bit for bit."""
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import TokenPipeline as JTokenPipeline
from repro.models import transformer as jtf
from repro.optim import adafactor as jadaf
from repro.optim import adamw as jadam
from repro_torch.checkpoint.manager import (CheckpointManager,
                                            _flatten_with_names)
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.launch import train as train_cli
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models.layers import tree_map
from repro_torch.optim import adafactor as adaf
from repro_torch.optim import adamw

from _torch_parity import tree_to_torch
from test_torch_train_loss import (assert_grads_close, reference,
                                   reference_grads, train_batch)

pytestmark = pytest.mark.tier1

ARCH = "qwen1.5-0.5b"
LOSS_RTOL = 1e-4


def _batches(cfg, n: int):
    data = dict(seed=0, batch=4, seq_len=32)
    port = TokenPipeline(cfg, DataConfig(**data))
    ref = JTokenPipeline(cfg, JDataConfig(**data))
    out = []
    for i in range(n):
        b = port.batch_at(i)
        assert all(np.array_equal(b[k], v)
                   for k, v in ref.batch_at(i).items())
        out.append(b)
    return out


def test_micro_train_matches_jax_and_resumes(tmp_path):
    jcfg, jparams, cfg, params = reference(ARCH)
    batches = _batches(cfg, 9)
    optc = jadam.AdamWConfig(lr=1e-3)

    @jax.jit
    def jstep(p, s, batch):
        loss, g = jax.value_and_grad(lambda q: jtf.loss_fn(q, jcfg, batch))(p)
        p, s, _ = jadam.adamw_update(optc, g, s, p)
        return p, s, loss

    def step(p, s, batch):
        loss, g = value_and_grad(cfg, p, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
        p, s, _ = adamw.adamw_update(adamw.AdamWConfig(lr=1e-3), g, s, p)
        return p, s, float(loss)

    jp, js = jparams, jadam.adamw_init(jparams)
    p, s = params, adamw.adamw_init(params)
    losses = []
    for b in batches[:8]:
        jp, js, jl = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        p, s, loss = step(p, s, b)
        assert abs(loss - float(jl)) <= LOSS_RTOL * abs(float(jl))
        losses.append(loss)
    assert losses[-1] < losses[0]
    assert_grads_close(p, tree_to_torch(jp), rtol=1e-3)

    mgr = CheckpointManager(str(tmp_path))
    mgr.save(8, {"p": p, "o": s}, blocking=False)
    mgr.wait()
    fresh = {"p": tree_map(torch.zeros_like, p),
             "o": adamw.adamw_init(p)}
    restored, at = mgr.restore(fresh)
    assert at == 8 and int(restored["o"]["count"]) == 8
    _, _, l1 = step(restored["p"], restored["o"], batches[8])
    _, _, l2 = step(p, s, batches[8])
    assert l1 == l2


@pytest.mark.parametrize("optimizer", ("adamw", "adafactor"))
def test_train_step_matches_the_reference_composition(optimizer):
    _, jparams, cfg, params = reference(ARCH)
    cfg = cfg.with_(optimizer=optimizer)
    batch = train_batch(cfg)
    loss, g = reference_grads(ARCH)      # the reference's on this batch
    step = 250                           # past the warm-up
    optc = jadam.AdamWConfig(lr=2e-3)
    lr = jadam.cosine_lr(jnp.asarray(step), peak=optc.lr, warmup=200,
                         total=10_000)
    if optimizer == "adafactor":
        want, _, jm = jax.jit(lambda g, p, lr: jadaf.adafactor_update(
            jadaf.AdafactorConfig(lr=optc.lr), g, jadaf.adafactor_init(p),
            p, lr=lr))(g, jparams, lr)
        state = adaf.adafactor_init(params)
    else:
        want, _, jm = jax.jit(lambda g, p, lr: jadam.adamw_update(
            optc, g, jadam.adamw_init(p), p, lr=lr))(g, jparams, lr)
        state = adamw.adamw_init(params)
    bundle = make_train_step(cfg, optc=adamw.AdamWConfig(lr=2e-3))
    # the step consumes its parameters; `reference` keeps them for others
    new, new_state, m = bundle.fn(tree_map(torch.clone, params), state, {
        k: torch.from_numpy(v) for k, v in batch.items()}, step)
    assert ("factors" in new_state) == (optimizer == "adafactor")
    assert abs(float(m["loss"]) - float(loss)) <= 1e-5 * float(loss)
    assert abs(float(m["lr"]) - float(lr)) <= 1e-6 * float(lr)
    assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-4 * float(jm["grad_norm"])
    assert int(new_state["count"]) == 1
    # each update within 1% of the learning rate: AdamW's first step
    # divides a gradient by its own size, so the update of an element
    # whose gradient is near eps moves with its gradient's last bits
    got, want, old = (_flatten_with_names(t) for t in (
        new, tree_to_torch(want), tree_to_torch(jparams)))
    for name, w in want.items():
        err = float(((got[name] - old[name]) - (w - old[name])).abs().max())
        assert err <= 1e-2 * float(lr), (name, err)


def _cli(tmp_path, steps, capsys, **extra):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps",
            str(steps), "--batch", "2", "--seq", "16", "--ckpt-every", "2",
            "--ckpt-dir", str(tmp_path)]
    for k, v in extra.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    losses = train_cli.main(argv)
    return losses, capsys.readouterr().out


def test_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    straight, _ = _cli(tmp_path / "straight", 6, capsys)
    assert len(straight) == 6 and all(np.isfinite(straight))

    first, out = _cli(tmp_path / "run", 4, capsys)
    assert "resumed" not in out and first == straight[:4]
    assert CheckpointManager(str(tmp_path / "run")).all_steps() == [2, 4]
    second, out = _cli(tmp_path / "run", 6, capsys)
    assert "resumed from step 4" in out
    assert second == straight[4:]
    assert re.search(r"final loss [\d.]+ \(first [\d.]+\)", out)

    # a crash after the mid-run checkpoint: resume from step 2 gives the
    # uninterrupted run's losses (a checkpoint is labelled with the steps
    # it has taken)
    mgr = CheckpointManager(str(tmp_path / "run"))
    for s in (4, 6):
        shutil.rmtree(tmp_path / "run" / f"step_{s}")
    assert mgr.latest_step() == 2
    again, out = _cli(tmp_path / "run", 6, capsys)
    assert "resumed from step 2" in out
    assert again == straight[2:]


def _count(directory, step: int) -> int:
    """The AdamW step count held by the CLI checkpoint of `step`."""
    from repro_torch.models import registry
    from repro_torch.models import transformer as tf
    params = tf.init_params(registry.get_config(ARCH, smoke=True),
                            torch.Generator().manual_seed(0), "cpu")
    tree, at = CheckpointManager(str(directory)).restore(
        {"params": params, "opt": adamw.adamw_init(params)}, step=step)
    assert at == step
    return int(tree["opt"]["count"])


def test_cli_labels_beside_the_reference_cli(tmp_path, capsys):
    # the reference CLI labels a mid-run checkpoint with the step it was
    # taken at, one fewer than the steps it holds; the port's with the
    # steps it holds; both label the final checkpoint with --steps.  So
    # the port resuming a reference mid-run checkpoint takes its last
    # step again (as the reference resuming its own does)
    from repro.launch import train as jtrain
    ref = tmp_path / "ref"
    jtrain.main(["--arch", ARCH, "--smoke", "--steps", "4", "--batch", "2",
                 "--seq", "16", "--mesh", "1x1", "--ckpt-every", "2",
                 "--ckpt-dir", str(ref)])
    capsys.readouterr()
    _cli(tmp_path / "port", 4, capsys)
    for d in (ref, tmp_path / "port"):
        assert CheckpointManager(str(d)).all_steps() == [2, 4]
    assert (_count(ref, 2), _count(ref, 4)) == (3, 4)
    assert (_count(tmp_path / "port", 2), _count(tmp_path / "port", 4)) \
        == (2, 4)
    shutil.rmtree(ref / "step_4")
    losses, out = _cli(ref, 4, capsys)
    assert "resumed from step 2" in out and len(losses) == 2
    assert _count(ref, 4) == 5


@pytest.mark.parametrize("flag,value", (("devices", 2), ("mesh", "2x2"),
                                        ("mesh", "production")))
def test_cli_refuses_distribution(tmp_path, capsys, flag, value):
    # a mesh runs one NCCL rank a card, with no fallback: without the cards
    # (none here) the CLI refuses it; gloo ranks (--device cpu) are in
    # tests/test_torch_dist_cli.py
    with pytest.raises(RuntimeError, match="cards"):
        _cli(tmp_path, 1, capsys, device="cuda", **{flag: value})


_RESIDENT: dict = {}


@pytest.mark.parametrize("mode", ("insitu", "naive_pp", "gpp"))
def test_cli_streams_as_resident(tmp_path, capsys, mode):
    # world size 1: every leaf is whole on the device, gpp copies it
    # through its ring; the same ops on the same bytes
    if not _RESIDENT:
        _RESIDENT["losses"] = _cli(tmp_path / "resident", 3, capsys,
                                   stream_mode="resident")[0]
    losses, _ = _cli(tmp_path / mode, 3, capsys, stream_mode=mode)
    assert losses == _RESIDENT["losses"] and len(losses) == 3


def test_cli_takes_one_device_layouts(tmp_path, capsys):
    losses, out = _cli(tmp_path, 1, capsys, devices=1, mesh="1x1",
                       stream_mode="resident")
    assert len(losses) == 1 and "device: cpu" in out


def test_cli_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--arch", ARCH, "--smoke", "--steps", "1"])
