"""Buffer donation in the port's step bundles, as the reference's jitted
steps donate (`donate_argnums`): the decode step writes its caches in the
storage it was given, the train step updates the parameters and the
optimizer state in theirs, and each returns the trees it was given.  On
the CPU, at SMOKE sizes in f32:

  * all ten archs: `transformer.decode_step(..., donate=True)` gives the
    functional `decode_step`'s logits and caches bit for bit over two
    steps, returns the caches it was given (every leaf's `data_ptr`), and
    both are within 1e-4 of the JAX package's `decode_step` (the tolerance
    of `test_torch_dense_steps.py`) on the same caches; the functional
    form leaves its input as it was;
  * three AdamW and three Adafactor steps of `launch.steps.
    make_train_step`, mesh-less and on a one-rank gloo 1x1 mesh, bit for
    bit the functional route (the step's gradients, then `adamw_update` /
    `adafactor_update` without `donate`), every parameter and state leaf
    in the storage it started in;
  * `launch.dryrun.count_step` of `make_decode_step` on meta tensors: the
    card's peak is below the arguments plus one cache (the functional
    decode holds a second).

The 2x2 gloo mesh's donated decodes (a sequence-split cache, head-split
recurrent states) run in `test_torch_dist_steps.py`'s spawn."""
import contextlib

import numpy as np
import pytest
import torch

from repro.models import transformer as jtf
from repro_torch.configs.base import ShapeConfig
from repro_torch.dist.collectives import on_mesh
from repro_torch.launch import dryrun, roofline, steps
from repro_torch.models import registry
from repro_torch.models import transformer as tf
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.optim import adafactor, adamw

from _torch_parity import np32
from test_torch_train_loss import reference

pytestmark = pytest.mark.tier1

TOL = 1e-4
B, S, MAX_LEN = 2, 6, 12


def _leaves(tree) -> list:
    return [t for t in tree_leaves(tree) if t is not None]


def _same_bits(a, b) -> bool:
    """Equal dtype, shape and bits (-0.0 is not 0.0)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    n = a.element_size()
    return a.dtype == b.dtype and a.shape == b.shape and bool(
        torch.equal(a.view(ints[n]), b.view(ints[n])))


def _all_same(got, want) -> bool:
    g, w = tree_leaves(got), tree_leaves(want)
    return len(g) == len(w) and all(
        (a is None and b is None) or (a is not None and b is not None
                                      and _same_bits(a, b))
        for a, b in zip(g, w))


def _to_numpy(tree):
    """Copies: the donated decode writes the tensors in place."""
    return tree_map(lambda t: None if t is None else t.numpy().copy(), tree)


def _close(got, want, path=()):
    """Walk the port's tree against the reference's (dict keys, list
    items, None leaves): each leaf within TOL of its largest |value|."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _close(got[k], want[k], path + (k,))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, path + (i,))
    elif want is None:
        assert got is None, path
    else:
        g, w = np32(got), np.asarray(want, np.float32)
        assert g.shape == w.shape, path
        assert np.abs(g - w).max() <= TOL * max(1.0, np.abs(w).max()), path


@pytest.mark.parametrize("arch", registry.ARCH_NAMES)
def test_donated_decode_is_the_functional_decode(arch):
    jcfg, jparams, cfg, params = reference(arch)
    rng = np.random.default_rng(0)

    def inputs(n):
        if cfg.input_mode == "tokens":
            return rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
        return rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)
    x = inputs(S)
    enc = (rng.standard_normal((B, cfg.encoder_tokens, cfg.d_model))
           .astype(np.float32) if cfg.encoder_tokens else None)
    tenc = None if enc is None else torch.from_numpy(enc)
    batch = {"tokens" if cfg.input_mode == "tokens" else "embeds":
             torch.from_numpy(x)} | ({} if enc is None else {"enc": tenc})
    _, caches = tf.prefill(params, cfg, batch, MAX_LEN)
    ptrs = [t.data_ptr() for t in _leaves(caches)]
    fc, jc = caches, _to_numpy(caches)
    for pos in (S, S + 1):
        nx = inputs(1)
        old = fc
        before = tree_map(lambda t: None if t is None else t.clone(), old)
        fl, fc = tf.decode_step(params, cfg, torch.from_numpy(nx), old, pos,
                                enc=tenc)
        assert _all_same(old, before)
        dl, dc = tf.decode_step(params, cfg, torch.from_numpy(nx), caches,
                                pos, enc=tenc, donate=True)
        assert dc is caches
        assert [t.data_ptr() for t in _leaves(dc)] == ptrs
        assert _same_bits(dl, fl) and _all_same(dc, fc)
        jl, jc = jtf.decode_step(jparams, jcfg, nx, jc, pos, enc=enc)
        _close(dl, jl)
        _close(dc, jc)


def test_functional_decode_leaves_its_caches():
    cfg = registry.get_config("zamba2-2.7b", smoke=True).with_(
        dtype="float32")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S + 1)))
    _, caches = tf.prefill(params, cfg, {"tokens": toks[:, :S]}, MAX_LEN)
    before = tree_map(lambda t: None if t is None else t.clone(), caches)
    _, new = tf.decode_step(params, cfg, toks[:, S:], caches, S)
    assert _all_same(caches, before) and not _all_same(new, before)
    assert not any(a.data_ptr() == b.data_ptr()
                   for a, b in zip(_leaves(new), _leaves(caches)))


@pytest.fixture(scope="module")
def mesh11():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already up")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


TRAIN_B, TRAIN_S, FIRST_STEP = 2, 16, 200    # past the warm-up


def _functional(cfg, bundle, mesh, optc):
    """The train step's route without donation: its gradients, then the
    update that copies the parameters and the state first."""
    def step(params, state, batch, i):
        if mesh is None:
            _, grads = steps.value_and_grad(cfg, params, batch)
            ctx, specs = contextlib.nullcontext(), None
        else:
            _, grads = bundle.meta["loss_and_grads"](params, batch)
            ctx = on_mesh(mesh, bundle.meta["rules"])
            specs = bundle.meta["param_pspecs"]
        with ctx:
            lr = adamw.cosine_lr(i, peak=optc.lr, warmup=200, total=10_000)
            if cfg.optimizer == "adafactor":
                return adafactor.adafactor_update(
                    adafactor.AdafactorConfig(lr=optc.lr), grads, state,
                    params, lr=lr, specs=specs)
            return adamw.adamw_update(optc, grads, state, params, lr=lr,
                                      specs=specs)
    return step


@pytest.mark.parametrize("on_1x1", (False, True), ids=("meshless", "1x1"))
@pytest.mark.parametrize("optimizer", ("adamw", "adafactor"))
def test_donated_train_steps_are_the_functional_route(optimizer, on_1x1,
                                                      request):
    mesh = request.getfixturevalue("mesh11") if on_1x1 else None
    cfg = registry.get_config("qwen1.5-0.5b", smoke=True).with_(
        dtype="float32", optimizer=optimizer)
    optc = adamw.AdamWConfig(lr=3e-3)
    bundle = steps.make_train_step(
        cfg, mesh, ShapeConfig("t", TRAIN_S, TRAIN_B, "train"), optc)
    functional = _functional(cfg, bundle, mesh, optc)
    params = tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    init = (adafactor.adafactor_init if optimizer == "adafactor"
            else adamw.adamw_init)
    fp, fs = params, init(params)
    dp, ds = tree_map(torch.clone, params), init(params)
    ptrs = [t.data_ptr() for t in tree_leaves((dp, ds))]
    rng = np.random.default_rng(4)
    for i in range(FIRST_STEP, FIRST_STEP + 3):
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (TRAIN_B, TRAIN_S))) for k in
            ("tokens", "labels")}
        fp, fs, fm = functional(fp, fs, batch, i)
        p, s, m = bundle.fn(dp, ds, batch, i)
        assert p is dp and s is ds
        assert [t.data_ptr() for t in tree_leaves((p, s))] == ptrs
        assert _all_same(p, fp) and _all_same(s, fs)
        assert _same_bits(m["grad_norm"], fm["grad_norm"])
    assert int(ds["count"]) == 3
    assert not _all_same(dp, params)          # the steps moved them


def test_dry_run_decode_holds_the_cache_once(mesh11):
    """`count_step` of a SMOKE decode cell on meta tensors: the peak is the
    arguments plus what the step allocates, below the arguments and one
    cache; the functional decode, run the same way, holds a second.  At 8
    layers, so that one layer's f32 copies of its K / V (`_sdpa`) are a
    fraction of the cache, as at the production cells' depths."""
    cfg = registry.get_config("qwen1.5-0.5b", smoke=True).with_(num_layers=8)
    shape = ShapeConfig("decode_64", 64, 4, "decode")
    bundle = steps.make_decode_step(cfg, mesh11, shape)
    args = dryrun.step_args(cfg, shape, bundle, mesh11)
    cache = roofline.tensor_bytes(args[2])
    rec = dryrun.count_step(bundle.fn, args, "decode")
    assert rec["alias_bytes"] == cache
    assert rec["argument_bytes"] < rec["hbm_bytes"] \
        < rec["argument_bytes"] + cache

    def functional(params, toks, caches, pos):
        return tf.decode_step(params, cfg, toks, caches, pos)
    fun = dryrun.count_step(functional, args, "decode")
    assert fun["hbm_bytes"] >= fun["argument_bytes"] + cache
    assert fun["flops_per_device"] == rec["flops_per_device"]
    assert fun["dot_bytes_per_device_loop_aware"] == \
        rec["dot_bytes_per_device_loop_aware"]
