"""The port's roofline module (`repro_torch.launch.roofline`) against the
JAX package's `repro.launch.roofline` on the CPU, mirroring
`tests/test_roofline.py`:

- `model_flops` equal to the reference's for the ten archs x their
  `cells_for` shapes;
- `analyze_record` / `Roofline` on the same synthetic records equal to the
  reference's with the port's constants set to the reference's v5e ones
  (its collective term divides by ICI_BW x ICI_LINKS), and the H100
  constants pinned by value;
- the counter (`roofline.count`) on synthetic programs: a matmul's 2MNK
  FLOPs and bytes, a 4-layer stack counting 4 x one layer (the
  counterpart of `test_multipliers`), each collective kind's count and
  bytes on a 4-rank fake group (the counterpart of
  `test_collective_bytes`; a group of one rank moves no bytes), the live
  peak of a known sequence;
- the FLOPs of the f32 SMOKE `forward` (B = 2, S = 64) counted on meta
  against `dot_flops_loop_aware` on the reference's compiled CPU HLO.
  Equal for eight archs.  zamba2 and xlstm: the port's eager chunked
  scans also compute the state carried out of the last chunk (Mamba2's
  "bsh,bshp,bsn->bhpn" product, the mLSTM's M and n), which `forward`
  drops; XLA removes that dead product from the reference's compiled
  forward.  At S = 64 (one chunk) the gate is exact: the port's count
  equals the reference's plus those products, layer by layer
  (`_dead_state_flops`), and nothing else (+4.0% / +3.5% of the count).
"""
import dataclasses
import gc

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.base import SHAPES as JSHAPES
from repro.launch import roofline as jrl
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro_torch.bridge import config_from_reference
from repro_torch.configs.base import SHAPES, cells_for
from repro_torch.dist import collectives as coll
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import fake_mesh
from repro_torch.models import registry
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import map_specs

pytestmark = pytest.mark.tier1

V5E = {"PEAK_FLOPS": jrl.PEAK_FLOPS, "HBM_BW": jrl.HBM_BW,
       "NET_BW": jrl.ICI_BW * jrl.ICI_LINKS}


def _cells():
    return [(a, s) for a in registry.ARCH_NAMES
            for s in cells_for(registry.get_config(a))]


@pytest.mark.parametrize("arch,shape", _cells())
def test_model_flops_match_reference(arch, shape):
    want = jrl.model_flops(jregistry.get_config(arch), JSHAPES[shape])
    assert rl.model_flops(registry.get_config(arch), SHAPES[shape]) == want


def test_h100_constants():
    assert rl.PEAK_FLOPS == 989e12
    assert rl.HBM_BW == 3.35e12
    assert rl.NET_BW == 50e9
    # torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100
    # 80GB HBM3 at 700.00 W
    assert rl.HBM_BYTES == 85_017_493_504


def _record(arch, shape, mesh, seed):
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(6, generator=g, dtype=torch.float64).tolist()
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "flops_per_device": 1e15 * u[0],
            "bytes_per_device": 1e12 * u[1],
            "collectives": {"all-gather": {"count": 7, "bytes": 1e11 * u[2]},
                            "all-reduce": {"count": 3, "bytes": 1e10 * u[3]},
                            "reduce-scatter": {"count": 2,
                                               "bytes": 1e9 * u[4]}}}


@pytest.mark.parametrize("mesh", ("16x16", "2x16x16"))
@pytest.mark.parametrize("arch,shape", _cells()[::3])
def test_analyze_record_matches_reference(monkeypatch, arch, shape, mesh):
    for k, v in V5E.items():
        monkeypatch.setattr(rl, k, v)
    rec = _record(arch, shape, mesh, seed=len(arch) + len(shape))
    want = jrl.analyze_record(rec, jregistry.get_config(arch),
                              JSHAPES[shape])
    got = rl.analyze_record(rec, registry.get_config(arch), SHAPES[shape])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.step_time_s == want.step_time_s
    assert got.roofline_fraction == want.roofline_fraction


def test_mesh_chips():
    assert rl.mesh_chips("16x16") == 256
    assert rl.mesh_chips("2x16x16") == 512
    assert rl.mesh_chips("1x1") == 1


# ---------------------------------------------------------------------------
# the counter on synthetic programs
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_matmul_flops_and_bytes(dtype):
    M, K, N = 8, 16, 32
    es = torch.empty((), dtype=dtype).element_size()
    out, c = rl.count(torch.matmul, _meta(M, K, dtype=dtype),
                      _meta(K, N, dtype=dtype))
    assert out.shape == (M, N)
    assert c["flops"] == 2 * M * N * K
    assert c["dot_bytes"] == es * (M * K + K * N + M * N)
    assert c["out_bytes"] == es * M * N
    assert c["peak_bytes"] == es * M * N
    assert c["dot_coverage"] == 1.0 and c["collectives"] == {}
    B = 3
    _, c = rl.count(torch.bmm, _meta(B, M, K, dtype=dtype),
                    _meta(B, K, N, dtype=dtype))
    assert c["flops"] == 2 * B * M * N * K
    assert c["dot_bytes"] == es * B * (M * K + K * N + M * N)


def _stack(x, ws):
    for w in ws:
        x = torch.tanh(x @ w) + x
    return x.sum()


def test_stack_counts_each_layer():
    # the counterpart of the reference's loop multipliers: eager runs every
    # layer, so L layers count L x one layer, forward and backward
    def run(L):
        x = _meta(8, 16).requires_grad_()
        ws = [_meta(16, 16).requires_grad_() for _ in range(L)]
        return rl.count(lambda: torch.autograd.grad(_stack(x, ws),
                                                    [x, *ws]))[1]
    zero, one, four = run(0), run(1), run(4)
    for k in ("flops", "dot_bytes", "out_bytes"):
        assert four[k] - zero[k] == 4 * (one[k] - zero[k]), k
    # forward x @ w, backward x^T @ g (for w) and g @ w^T (for x)
    assert zero["flops"] == 0
    assert one["flops"] == 3 * 2 * 8 * 16 * 16


def test_counter_equals_flop_counter_mode():
    cfg = registry.get_config("qwen1.5-0.5b", smoke=True).with_(
        dtype="float32")
    params = map_specs(lambda _, s: _meta(*s.shape, dtype=s.dtype),
                       tf.param_specs(cfg))
    batch = {"tokens": _meta(2, 16, dtype=torch.int32)}
    _, c = rl.count(tf.forward, params, cfg, batch)
    with FlopCounterMode(display=False) as fc:
        tf.forward(params, cfg, batch)
    assert c["flops"] == fc.get_total_flops() > 0


def test_collective_counts_and_bytes():
    if dist.is_initialized():
        pytest.skip("a process group is already up")

    def step(par):
        x = _meta(8, 16)                                  # 512 B
        coll.all_gather(x, par.group("data"), 2)          # out 2 x 512
        coll.all_gather(x, par.group("model"), 2)
        coll.reduce_scatter(_meta(8, 16), 0, par.group("model"), 2)  # 256
        coll.all_reduce(x, par, ("data", "model"))        # 2 x 512
        outs = [_meta(4, 16) for _ in range(2)]
        dist.all_to_all(outs, [_meta(4, 16) for _ in range(2)],
                        group=par.group("data"))          # 2 x 256
        coll.all_reduce(x, par, "pod")                    # a group of one

    with fake_mesh((1, 2, 2), ("pod", "data", "model")) as mesh:
        _, c = rl.count(step, coll.Par(mesh))
    assert c["collectives"] == {
        "all-gather": {"count": 2, "bytes": 2 * 1024},
        "reduce-scatter": {"count": 1, "bytes": 256},
        "all-reduce": {"count": 2, "bytes": 2 * 512},
        "all-to-all": {"count": 1, "bytes": 512}}
    assert not dist.is_initialized()


def test_fake_mesh_refuses_a_second_group():
    if dist.is_initialized():
        pytest.skip("a process group is already up")
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        assert dist.get_world_size() == 4 and dist.get_rank() == 0
        assert mesh.get_local_rank("model") == 0
        with pytest.raises(RuntimeError, match="process group is up"):
            with fake_mesh((2,), ("data",)):
                pass
    assert not dist.is_initialized()


def test_live_peak_of_a_known_sequence():
    def seq():
        a = _meta(1024)                         # 4096 B
        b = _meta(2048)                         # + 8192 = 12288
        del a
        v = b.view(2, 1024)                     # a view: no new storage
        del b
        c = _meta(256)                          # 8192 + 1024
        return v, c

    (v, c), got = rl.count(seq)
    assert got["peak_bytes"] == 12288
    assert got["out_bytes"] == 4096 + 8192 + 1024
    # autograd's saved tensors stay live until the backward frees them
    w = _meta(16, 16).requires_grad_()

    def saved():
        h = _meta(4, 16)                        # 256 B, saved by the mm
        z = torch.tanh(h @ w)                   # tanh's output, saved: 256
        del h
        return z, _meta(256)                    # 1024

    out, got = rl.count(saved)
    assert got["peak_bytes"] == 256 + 256 + 1024
    del out
    gc.collect()


# ---------------------------------------------------------------------------
# FLOPs against the reference's compiled HLO
# ---------------------------------------------------------------------------

PARITY = ("qwen1.5-0.5b", "deepseek-v2-lite-16b", "gemma3-12b",
          "kimi-k2-1t-a32b", "zamba2-2.7b", "xlstm-1.3b")
B, S = 2, 64


def _dead_state_flops(cfg) -> int:
    """FLOPs of the recurrent state each chunked scan carries out of the
    last chunk of a forward (which the forward drops): 2BLHPN a Mamba2
    layer, 2BLhd(d + 1) an mLSTM layer, L = the last chunk's positions."""
    kinds = list(cfg.prefix_pattern) + list(cfg.pattern) * cfg.num_superblocks
    n = 0
    for kind in kinds:
        base = kind.split(":")[0]
        if base == "mamba":
            c = tf._ssm_cfg(cfg)
            L = min(ssm_mod.SSD_CHUNK, S)
            n += 2 * B * L * c.n_heads * c.head_dim * c.d_state
        elif base == "mlstm":
            c = tf._xlstm_cfg(cfg)
            L = min(xlstm_mod.MLSTM_CHUNK, S)
            n += 2 * B * L * c.n_heads * c.head_dim * (c.head_dim + 1)
    return n


@pytest.mark.parametrize("arch", PARITY)
def test_forward_flops_match_reference_hlo(arch):
    jcfg = jregistry.get_config(arch, smoke=True).with_(dtype="float32")
    cfg = config_from_reference(jcfg)
    jparams = jax.eval_shape(lambda: jtf.init_params(jcfg,
                                                     jax.random.PRNGKey(0)))
    jbatch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    hlo = jax.jit(lambda p, b: jtf.forward(p, jcfg, b)).lower(
        jparams, jbatch).compile().as_text()
    want, cov = jrl.dot_flops_loop_aware(hlo, jcfg.num_superblocks)
    assert cov == 1.0
    params = map_specs(lambda _, s: _meta(*s.shape, dtype=s.dtype),
                       tf.param_specs(cfg))
    _, c = rl.count(tf.forward, params, cfg,
                    {"tokens": _meta(B, S, dtype=torch.int32)})
    dead = _dead_state_flops(cfg)
    assert (dead > 0) == (arch in ("zamba2-2.7b", "xlstm-1.3b"))
    assert c["flops"] == want + dead
    assert c["dot_coverage"] == 1.0
