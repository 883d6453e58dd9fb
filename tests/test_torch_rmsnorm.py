"""The port's RMSNorm route, on the CPU.

The kernel (`rmsnorm_kernel`, csrc/rmsnorm.cu) runs only on the card
(tests/test_torch_cuda.py, chip_smoke.py); here:
  * its plain version, `kernels.ref.rmsnorm_ref`, against the JAX
    package's `repro.models.layers.rmsnorm` on numpy inputs from a seed, at
    the served models' widths (512, 1024, 1536, 2048) and a narrow one:
    f32 within 1e-6 (both sum the same f32 squares, in another order), bf16
    within one bf16 step of the reference's value (the f32 result rounds
    to bf16 on both sides, so a different last bit of the f32 sum can move
    it by one step);
  * `kernels.ops.rmsnorm` routes a CPU tensor to the plain version under
    "auto" and "ref" and launches nothing; "kernel" on a CPU tensor, and
    the kernel's wrapper itself, raise;
  * the models pass their `dense_kernel` mode to every RMSNorm (ln1, ln2,
    the final norm, MLA's kv_norm and q_norm), so a run in "ref" mode
    launches no kernel.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import layers as JL
from repro_torch.kernels import ops
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels.ref import rmsnorm_ref
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models import transformer as tf

from _torch_parity import np32, t

pytestmark = pytest.mark.tier1

WIDTHS = (512, 1024, 1536, 2048, 40)


def _inputs(width, dtype, rows=(3, 5), seed=0):
    rng = np.random.default_rng(seed + width)
    x = (rng.standard_normal((*rows, width)) * 2).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(width)).astype(np.float32)
    return jnp.asarray(x, dtype), jnp.asarray(s, dtype)


@pytest.mark.parametrize("width", WIDTHS)
def test_plain_matches_jax_f32(width):
    x, s = _inputs(width, jnp.float32)
    want = JL.rmsnorm({"scale": s}, x)
    got = rmsnorm_ref(t(x), t(s))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np32(got), np32(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("width", WIDTHS)
def test_plain_matches_jax_bf16(width):
    x, s = _inputs(width, jnp.bfloat16, seed=1)
    want = np32(JL.rmsnorm({"scale": s}, x))
    got = rmsnorm_ref(t(x), t(s))
    assert got.dtype == torch.bfloat16
    step = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                   - 7)
    assert (np.abs(np32(got) - want) <= step).all()


@pytest.mark.parametrize("eps", (1e-6, 1e-5))
def test_plain_keeps_the_reference_steps(eps):
    # rsqrt(sum / d + eps), then (x * r) * scale, in f32
    x, s = _inputs(64, jnp.float32, rows=(4,))
    xf = torch.tensor(np.asarray(x))
    r = torch.rsqrt((xf * xf).sum(-1, keepdim=True) / 64 + eps)
    assert torch.equal(rmsnorm_ref(xf, t(s), eps),
                       xf * r * torch.tensor(np.asarray(s)))
    np.testing.assert_allclose(
        np32(rmsnorm_ref(xf, t(s), eps)),
        np32(JL.rmsnorm({"scale": s}, x, eps)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ("auto", "ref"))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_ops_routes_cpu_tensors_to_the_plain_version(mode, dtype):
    x = torch.randn(4, 5, 1024).to(dtype)
    p = {"scale": (1 + 0.1 * torch.randn(1024)).to(dtype)}
    before = rn.launches_rmsnorm.n
    want = rmsnorm_ref(x, p["scale"])
    assert torch.equal(ops.rmsnorm(p, x, 1e-6, mode), want)
    assert torch.equal(L.rmsnorm(p, x, mode=mode), want)
    assert rn.launches_rmsnorm.n == before


def test_kernel_mode_and_the_wrapper_raise_on_cpu():
    x = torch.randn(2, 64)
    p = {"scale": torch.ones(64)}
    with pytest.raises(ValueError, match="CUDA"):
        ops.rmsnorm(p, x, 1e-6, "kernel")
    with pytest.raises(ValueError, match="CUDA"):
        L.rmsnorm(p, x, mode="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        rn.rmsnorm(x, p["scale"])
    with pytest.raises(ValueError, match="mode"):
        ops.rmsnorm(p, x, 1e-6, "fast")


@pytest.mark.parametrize("arch,q_lora", (("qwen1.5-0.5b", None),
                                         ("deepseek-v2-lite-16b", None),
                                         ("deepseek-v2-lite-16b", 32)))
def test_models_pass_their_mode_to_every_norm(monkeypatch, arch, q_lora):
    # one decode step on the smoke config in "ref" mode: every RMSNorm
    # (ln1 and ln2 a layer, the final norm; MLA: kv_norm, and q_norm with a
    # q compression) gets the model's mode, so none launches a kernel
    cfg = registry.get_config(arch, smoke=True).with_(
        dtype="float32", dense_kernel="ref")
    if q_lora:
        cfg = cfg.with_(q_lora_rank=q_lora)
    seen = []
    plain = ops.rmsnorm

    def spy(p, x, eps=1e-6, mode="auto"):
        seen.append((p["scale"].shape[0], mode))
        return plain(p, x, eps, mode)

    monkeypatch.setattr(ops, "rmsnorm", spy)
    params = tf.serving_params(tf.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), cfg)
    caches = tf.init_paged_caches(tf.paged_cache_specs(cfg, 5, 8), "cpu")
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    logits, _ = tf.decode_step_paged(
        params, cfg, torch.tensor([[1], [2]]), caches, tables,
        torch.tensor([3, 9], dtype=torch.int32),
        torch.ones(2, dtype=torch.bool))
    assert torch.isfinite(logits).all()
    mla = arch.startswith("deepseek")
    per_layer = 2 + (1 if mla else 0) + (1 if q_lora else 0)
    assert len(seen) == per_layer * cfg.num_layers + 1
    assert {m for _, m in seen} == {"ref"}
    widths = {w for w, _ in seen}
    assert cfg.d_model in widths
    if mla:
        assert cfg.kv_lora_rank in widths
    if q_lora:
        assert q_lora in widths


def test_dataclass_mode_default_is_auto():
    # the model configs route by device unless asked: the kernel on a CUDA
    # tensor, the plain version on the CPU
    cfg = registry.get_config("qwen1.5-0.5b", smoke=True)
    assert dataclasses.asdict(cfg)["dense_kernel"] == "auto"
