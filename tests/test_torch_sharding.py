"""The port's sharding rules (`repro_torch.dist.sharding`) and meshes
(`repro_torch.launch.mesh`) against the JAX package's on the CPU: the
per-leaf specs of `_leaf_pspec`, `param_pspecs`, `sharded_pspecs_one_layer`
and `gathered_pspecs` equal the reference's `PartitionSpec`s (as tuples)
for every leaf of every block kind of the ten SMOKE configs, at mesh sizes
1x1, 2x1, 4x2 and 2x4 and under the rule variants the reference's
launcher builds.  The reference reads a mesh only through `mesh.shape`, so
no JAX devices are needed.  `launch.steps.stream_specs` equals the
reference's `_stream_pspecs`.  Meshes over process groups are in
`test_torch_streamer_dist.py`."""
import types

import jax
import pytest

from jax.sharding import PartitionSpec as P
from repro.dist import sharding as jshd
from repro.launch import steps as jsteps
from repro.models import registry as jregistry
from repro.models import transformer as jtf
from repro_torch.bridge import config_from_reference
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh as pmesh
from repro_torch.launch.steps import stream_specs
from repro_torch.models import transformer as tf
from repro_torch.models.registry import ARCH_NAMES

pytestmark = pytest.mark.tier1

MESHES = ((1, 1), (2, 1), (4, 2), (2, 4))
RULES = {
    "default": {},
    "no_fsdp": {"fsdp": False},
    "experts_dp": {"moe_ep_mode": "dp"},
    "pod_data": {"fsdp_axes": ("pod", "data"), "dp_axes": ("pod", "data")},
}


def _sizes(data, model, pod=None):
    sizes = {"data": data, "model": model}
    if pod:
        sizes = {"pod": pod, **sizes}
    return sizes


def _jflat(tree) -> dict:
    """{path: spec tuple} of a reference PartitionSpec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            tuple(spec) for path, spec in leaves}


def _flat(tree, path=()) -> dict:
    """{path: spec tuple} of a port spec tree."""
    if isinstance(tree, dict):
        return {p: s for k, v in tree.items()
                for p, s in _flat(v, path + (k,)).items()}
    if isinstance(tree, list):
        return {p: s for i, v in enumerate(tree)
                for p, s in _flat(v, path + (i,)).items()}
    return {path: tree}


def _cfgs(arch):
    jcfg = jregistry.get_config(arch, smoke=True)
    return jcfg, config_from_reference(jcfg)


def test_rules_and_name_sets_match_reference():
    assert shd.ShardRules() == shd.ShardRules(
        **{k: getattr(jshd.ShardRules(), k) for k in
           ("tp_axis", "fsdp_axes", "dp_axes", "fsdp", "moe_ep_mode",
            "moe_serve_resident")})
    assert shd._ROW_PARALLEL == jshd._ROW_PARALLEL
    assert shd._REPLICATED == jshd._REPLICATED


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_block_specs_match_reference(arch, mesh):
    jcfg, cfg = _cfgs(arch)
    sizes = _sizes(*mesh)
    jmesh = types.SimpleNamespace(shape=sizes)
    kinds = dict.fromkeys(tuple(cfg.prefix_pattern) + tuple(cfg.pattern))
    for kind in kinds:
        jone, one = jtf.block_specs(jcfg, kind), tf.block_specs(cfg, kind)
        for name, rules in RULES.items():
            jr, r = jshd.ShardRules(**rules), shd.ShardRules(**rules)
            for jfn, fn in ((jshd.sharded_pspecs_one_layer,
                             shd.sharded_pspecs_one_layer),
                            (jshd.gathered_pspecs, shd.gathered_pspecs)):
                want = _jflat(jfn(jone, jmesh, jr))
                got = _flat(fn(one, sizes, r))
                assert got == want, (kind, name, fn.__name__)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference(arch, mesh):
    jcfg, cfg = _cfgs(arch)
    for pod in (None, 2):
        sizes = _sizes(*mesh, pod=pod)
        jmesh = types.SimpleNamespace(shape=sizes)
        for rules in RULES.values():
            want = _jflat(jshd.param_pspecs(jtf.param_specs(jcfg), jmesh,
                                            jshd.ShardRules(**rules)))
            got = _flat(shd.param_pspecs(tf.param_specs(cfg), sizes,
                                         shd.ShardRules(**rules)))
            assert got == want


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_stream_specs_match_reference(arch, mesh):
    jcfg, cfg = _cfgs(arch)
    sizes = _sizes(*mesh)
    jmesh = types.SimpleNamespace(shape=sizes)
    jr = jsteps._rules_for(jcfg, jmesh)
    rules = shd.ShardRules(**{k: getattr(jr, k) for k in
                              ("tp_axis", "fsdp_axes", "dp_axes", "fsdp",
                               "moe_ep_mode", "moe_serve_resident")})
    for want, got in zip(jsteps._stream_pspecs(jcfg, jmesh, jr),
                         stream_specs(cfg, sizes, rules)):
        assert _flat(got) == _jflat(want)


@pytest.mark.parametrize("shape,lead,name", (
    ((64, 128), 0, "w_q"), ((64, 128), 0, "w_o"), ((4, 64, 128), 1, "w_up"),
    ((8, 64, 128), 0, "w_gate"), ((4, 8, 64, 128), 1, "w_down"),
    ((100, 64), 0, "embedding"), ((64,), 0, "scale"), ((64, 64), 0, "b_q"),
    ((3, 5), 0, "w_in"), ((6, 4), 0, "w_out")))
@pytest.mark.parametrize("mesh", MESHES + ((8, 1), (1, 8)),
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_leaf_pspec_matches_reference(shape, lead, name, mesh):
    sizes = _sizes(*mesh)
    jmesh = types.SimpleNamespace(shape=sizes)
    for rules in RULES.values():
        for fsdp in (None, False, True):
            want = jshd._leaf_pspec(shape, lead, name, jmesh,
                                    jshd.ShardRules(**rules), fsdp=fsdp)
            got = shd._leaf_pspec(shape, lead, name, sizes,
                                  shd.ShardRules(**rules), fsdp=fsdp)
            assert got == tuple(want)


def test_axis_sizes():
    assert shd.axis_sizes(None) == {}
    assert shd.axis_sizes({"data": 2}) == {"data": 2}
    fake = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=(4, 2))
    assert shd.axis_sizes(fake) == {"data": 4, "model": 2}


def test_host_mesh_needs_a_process_group():
    import torch.distributed as dist
    if dist.is_initialized():
        pytest.skip("a process group is already up")
    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        pmesh.make_host_mesh(2, 2)
    with pytest.raises(RuntimeError, match="process group of 256 ranks"):
        pmesh.make_production_mesh()


def test_dp_axes():
    assert pmesh.dp_axes({"data": 2, "model": 2}) == ("data",)
    assert pmesh.dp_axes({"pod": 2, "data": 16, "model": 16}) == \
        ("pod", "data")
