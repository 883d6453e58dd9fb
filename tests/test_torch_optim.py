"""The port's optimizers (`repro_torch.optim`) against the JAX package's on
the CPU, on the same trees from a numpy seed: `adamw_update` (with and
without clipping, and with `compress="bf16"`), `adafactor_update`
(factored leaves of rank 2 and 3, unfactored 1-D leaves, weight decay),
`cosine_lr` and `global_norm`, over three steps.  f32 results within 1e-6
relative; bf16 parameters within one bf16 step (their 16-bit patterns at
most 1 apart).  Also the reference's own cases (convergence on a
quadratic, clipping, Adafactor's small state, specs equal to the state),
and `bridge.opt_state_from_numpy` on the reference's states."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim import adafactor as jadaf
from repro.optim import adamw as jadam
from repro_torch.bridge import opt_state_from_numpy
from repro_torch.checkpoint.manager import _flatten_with_names
from repro_torch.models.layers import Spec, tree_leaves, tree_map
from repro_torch.optim import adafactor as adaf
from repro_torch.optim import adamw as adam

from _torch_parity import np32, tree_to_torch

pytestmark = pytest.mark.tier1

RTOL = 1e-6


def _trees(seed: int, bf16: bool, big: bool = False):
    """(params, three gradient trees) as numpy: f32 leaves of rank 1-3
    and, with bf16, bf16 ones (ml_dtypes) beside them; `big` scales the
    gradients past the clip norm."""
    import ml_dtypes
    rng = np.random.default_rng(seed)
    shapes = {"w": (8, 6), "stack": [(3, 5, 4)], "b": (7,),
              "blocks": {"ln": (6,), "w_up": (6, 10)}}
    bf = {"w", "b"} if bf16 else set()

    def make(scale):
        def leaf(name, shape):
            a = (rng.standard_normal(shape) * scale).astype(np.float32)
            return a.astype(ml_dtypes.bfloat16) if name in bf else a
        return {"w": leaf("w", shapes["w"]),
                "stack": [leaf("stack", shapes["stack"][0])],
                "b": leaf("b", shapes["b"]),
                "blocks": {k: leaf(k, s)
                           for k, s in shapes["blocks"].items()}}
    params = make(0.5)
    grads = [make(50.0 if big else 0.1) for _ in range(3)]
    return params, grads


def _close(got, want, what=""):
    """Trees by leaf name: f32 within RTOL relative (of the leaf's
    largest |value|), bf16 within one bf16 step, ints equal."""
    got, want = _flatten_with_names(got), _flatten_with_names(want)
    assert got.keys() == want.keys(), what
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype, (what, name)
        if g.dtype == torch.bfloat16:
            d = (g.view(torch.int16).int() - w.view(torch.int16).int()).abs()
            assert int(d.max()) <= 1, (what, name)
        elif g.is_floating_point():
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g - w).abs().max()) <= RTOL * scale, (what, name)
        else:
            assert torch.equal(g, w), (what, name)


def _run(port_update, ref_update, port_init, ref_init, params, grads):
    """Three steps of both; the trees and metrics after each compared."""
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_to_torch(params)
    js, ts = ref_init(jp), port_init(tp)
    _close(ts, tree_to_torch(js), "init")
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jp, js, jm = ref_update(jax.tree.map(jnp.asarray, g), js, jp, lr=lr)
        tp, ts, tm = port_update(tree_to_torch(g), ts, tp, lr=lr)
        _close(tp, tree_to_torch(jp), f"params, step {i}")
        _close(ts, tree_to_torch(js), f"state, step {i}")
        for k in ("grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= RTOL * abs(
                float(jm[k])), (k, i)


@pytest.mark.parametrize("case", ("plain", "clipped", "compress_bf16",
                                  "bf16_params"))
def test_adamw_matches_jax(case):
    params, grads = _trees(1, bf16=case == "bf16_params",
                           big=case == "clipped")
    cfg = dict(compress="bf16" if case == "compress_bf16" else None)
    _run(lambda *a, **k: adam.adamw_update(adam.AdamWConfig(**cfg), *a, **k),
         lambda *a, **k: jadam.adamw_update(jadam.AdamWConfig(**cfg), *a,
                                            **k),
         adam.adamw_init, jadam.adamw_init, params, grads)


@pytest.mark.parametrize("case", ("f32", "bf16_params", "weight_decay"))
def test_adafactor_matches_jax(case):
    params, grads = _trees(2, bf16=case == "bf16_params")
    cfg = dict(weight_decay=0.01 if case == "weight_decay" else 0.0)
    _run(lambda *a, **k: adaf.adafactor_update(
            adaf.AdafactorConfig(**cfg), *a, **k),
         lambda *a, **k: jadaf.adafactor_update(
            jadaf.AdafactorConfig(**cfg), *a, **k),
         adaf.adafactor_init, jadaf.adafactor_init, params, grads)


def test_adamw_without_lr_uses_the_config():
    params, grads = _trees(3, bf16=False)
    cfg = jadam.AdamWConfig(lr=0.05)
    jp, _, jm = jadam.adamw_update(cfg, jax.tree.map(jnp.asarray, grads[0]),
                                   jadam.adamw_init(jax.tree.map(
                                       jnp.asarray, params)),
                                   jax.tree.map(jnp.asarray, params))
    tp, _, tm = adam.adamw_update(adam.AdamWConfig(lr=0.05),
                                  tree_to_torch(grads[0]),
                                  adam.adamw_init(tree_to_torch(params)),
                                  tree_to_torch(params))
    _close(tp, tree_to_torch(jp))
    assert float(tm["lr"]) == pytest.approx(0.05)


def test_cosine_lr_matches_jax():
    for step in (0, 1, 100, 199, 200, 201, 1000, 5000, 9999, 10_000,
                 20_000):
        want = float(jadam.cosine_lr(jnp.asarray(step), peak=3e-4,
                                     warmup=200, total=10_000))
        for s in (step, torch.tensor(step)):
            got = float(adam.cosine_lr(s, peak=3e-4, warmup=200,
                                       total=10_000))
            assert abs(got - want) <= RTOL * max(want, 1e-12), step


def test_global_norm_matches_jax():
    params, _ = _trees(4, bf16=True)
    want = float(jadam.global_norm(jax.tree.map(jnp.asarray, params)))
    got = float(adam.global_norm(tree_to_torch(params)))
    assert abs(got - want) <= RTOL * want


# -- the reference's own cases (tests/test_substrates.py), on the port ----

def _quadratic_grads(params):
    return tree_map(lambda p: 2.0 * p.float(), params)


def _quadratic(params):
    return sum(float(torch.sum(p.float() ** 2))
               for p in tree_leaves(params))


def test_adamw_converges_on_quadratic():
    params = {"w": torch.ones(8, 8), "b": torch.ones(8)}
    cfg = adam.AdamWConfig(lr=0.1, weight_decay=0.0)
    state = adam.adamw_init(params)
    for _ in range(60):
        params, state, _ = adam.adamw_update(cfg, _quadratic_grads(params),
                                             state, params)
    assert _quadratic(params) < 0.1          # from 72.0 at init
    assert state["count"].dtype == torch.int32 and int(state["count"]) == 60


def test_adamw_clipping_reports_the_norm_before_clipping():
    params = {"w": torch.ones(4)}
    _, _, metrics = adam.adamw_update(adam.AdamWConfig(lr=1e-3),
                                      {"w": torch.full((4,), 1e6)},
                                      adam.adamw_init(params), params)
    assert float(metrics["grad_norm"]) > 1e5


def test_adamw_decays_every_leaf_and_keeps_f32_moments():
    # weight decay on norms and biases too (the reference's choice)
    params = {"scale": torch.ones(4, dtype=torch.bfloat16),
              "bias": torch.full((4,), 0.5)}
    new, state, _ = adam.adamw_update(
        adam.AdamWConfig(lr=0.1, weight_decay=0.5),
        tree_map(torch.zeros_like, params), adam.adamw_init(params),
        params)
    assert float(new["scale"][0]) < 1.0 and float(new["bias"][0]) < 0.5
    assert new["scale"].dtype == torch.bfloat16
    assert all(t.dtype == torch.float32
               for t in tree_leaves([state["mu"], state["nu"]]))


def test_adafactor_converges_and_state_is_small():
    params = {"w": torch.ones(32, 16)}
    cfg = adaf.AdafactorConfig(lr=0.3)
    state = adaf.adafactor_init(params)
    assert sum(t.numel() for t in tree_leaves(state["factors"])) == \
        32 + 16                              # factored: r + c, not r * c
    for _ in range(80):
        params, state, _ = adaf.adafactor_update(
            cfg, _quadratic_grads(params), state, params)
    assert _quadratic(params) < 1.0


def test_state_specs_match_init():
    params = {"w": torch.ones(8, 4), "v": torch.ones(5),
              "s": [torch.ones(2, 3, 4, dtype=torch.bfloat16)]}
    specs = tree_map(lambda p: Spec(tuple(p.shape), p.dtype), params)
    for spec_fn, init in ((adaf.adafactor_state_specs, adaf.adafactor_init),
                          (adam.adamw_state_specs, adam.adamw_init)):
        got = spec_fn(specs)
        want = tree_map(lambda t: Spec(tuple(t.shape), t.dtype),
                             init(params))
        assert got == want


def test_opt_state_from_the_reference():
    params, _ = _trees(5, bf16=True)
    jp = jax.tree.map(jnp.asarray, params)
    for init, port_init in ((jadam.adamw_init, adam.adamw_init),
                            (jadaf.adafactor_init, adaf.adafactor_init)):
        got = opt_state_from_numpy(jax.tree.map(np.asarray, init(jp)))
        _close(got, port_init(tree_to_torch(params)))
    with pytest.raises(ValueError, match="AdamW or Adafactor"):
        opt_state_from_numpy({"mu": {}, "count": np.int32(0)})
    assert np32(got["factors"]["w"]["vr"]).shape == (8,)
