"""The port's sharding policies (``repro_torch.distributed.policies``) and
hints (``constraints``) against the reference's: every placement, leaf by
leaf, equals ``tuple()`` of the reference's ``PartitionSpec`` — over the
port's own parameter trees of the registry's reduced configs, over the
published configs' shapes, and for the input and cache specs under both
production meshes.  The reference's mesh functions read only
``axis_names`` and ``shape``, so one ``MeshShape`` feeds both sides."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.distributed import policies as ref_pol
from repro.models import gnn as ref_gnn
from repro.models.recsys import wide_deep as ref_wd
from repro.models.transformer import model as ref_tm
from repro_torch import configs
from repro_torch.distributed import policies as pol
from repro_torch.distributed.constraints import shard_hint
from repro_torch.models.gnn import init_gnn
from repro_torch.models.recsys import init_wide_deep
from repro_torch.models.transformer import model as tm

MESHES = [pol.SINGLE_POD, pol.MULTI_POD]
LM_ARCHS = [a for a in configs.ARCH_IDS if configs.get_config(a).family == "lm"]


def _by_path(tree, prefix=""):
    """'/'-joined path -> leaf of a nested dict/list tree (a placement tuple
    or a ``PartitionSpec`` is a leaf)."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _by_path(sub, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {p: v for i, sub in enumerate(tree) for p, v in _by_path(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _assert_specs_equal(mine, ref):
    got, want = _by_path(mine), _by_path(ref)
    assert set(got) == set(want)
    for path, spec in got.items():
        assert isinstance(spec, tuple)
        assert spec == tuple(want[path]), (path, spec, want[path])


def _ref_params(spec, cfg):
    """The reference's parameter shapes of ``cfg`` (abstract: no arrays)."""
    init = {"lm": ref_tm.init_params, "gnn": ref_gnn.init_gnn,
            "recsys": ref_wd.init_wide_deep}[spec.family]
    return jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))


def _port_params(spec, cfg):
    gen = torch.Generator().manual_seed(0)
    if spec.family == "lm":
        return tm.init_params(cfg, gen, device="cpu")
    return (init_gnn if spec.family == "gnn" else init_wide_deep)(cfg, gen, device="cpu")


def _specs(mod, family, tree, moe_mode):
    if family == "lm":
        return mod.lm_param_specs(tree, moe_mode)
    return getattr(mod, f"{family}_param_specs")(tree)


@pytest.mark.parametrize("arch,moe_mode", [(a, "expert") for a in configs.ARCH_IDS]
                         + [(a, "tp") for a in LM_ARCHS])
def test_param_specs_of_the_ports_trees_equal_reference(arch, moe_mode):
    """The port's trees of the reduced configs get, path by path, the
    placements the reference gives its own trees of the same configs."""
    spec, ref_spec = configs.get_config(arch), ref_configs.get_config(arch)
    mine = _specs(pol, spec.family, _port_params(spec, spec.reduced_cfg), moe_mode)
    ref = _specs(ref_pol, spec.family, _ref_params(ref_spec, ref_spec.reduced_cfg), moe_mode)
    _assert_specs_equal(mine, ref)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_specs_at_published_widths_equal_reference(arch):
    """At the published configs' shapes the same function of the same
    shapes."""
    ref_spec = ref_configs.get_config(arch)
    shapes = _ref_params(ref_spec, ref_spec.model_cfg)
    for mode in (("expert", "tp") if ref_spec.family == "lm" else ("expert",)):
        mine = _specs(pol, ref_spec.family, shapes, mode)
        _assert_specs_equal(mine, _specs(ref_pol, ref_spec.family, shapes, mode))


def test_gnn_threshold_equals_reference():
    """2-D leaves of at least 2**20 elements shard their feature dim; no
    registry GNN has one, so stand-in shapes on both sides."""
    shapes = {"big": jax.ShapeDtypeStruct((1024, 1024), np.float32),
              "under": jax.ShapeDtypeStruct((1023, 1024), np.float32),
              "vec": jax.ShapeDtypeStruct((1 << 21,), np.float32),
              "layers": [{"w": jax.ShapeDtypeStruct((4096, 512), np.float32)}]}
    mine = pol.gnn_param_specs(shapes)
    _assert_specs_equal(mine, ref_pol.gnn_param_specs(shapes))
    assert mine["big"] == (None, "model") and mine["under"] == () and mine["vec"] == ()


@pytest.mark.parametrize("mesh", MESHES, ids=["pod", "multipod"])
def test_mesh_specs_equal_reference(mesh):
    assert pol.dp_axes(mesh) == ref_pol.dp_axes(mesh)
    assert pol.dp_size(mesh) == ref_pol.dp_size(mesh) == int(np.prod(mesh.sizes[:-1]))
    for extra in (0, 1, 2):
        assert pol.batch_spec(mesh, extra) == tuple(ref_pol.batch_spec(mesh, extra))
    for batch in (1, 16, 32, 256):
        assert pol.batch_axes_or_none(mesh, batch) == ref_pol.batch_axes_or_none(mesh, batch)
    _assert_specs_equal(pol.lm_input_specs(mesh), ref_pol.lm_input_specs(mesh))
    for batch, kv_heads in ((256, 8), (1, 32), (32, 16)):
        for kv_shard in ("seq", "heads"):
            _assert_specs_equal(pol.lm_cache_specs(mesh, batch, kv_heads, kv_shard),
                                ref_pol.lm_cache_specs(mesh, batch, kv_heads, kv_shard))
    keys = ["node_feat", "pos", "edge_src", "edge_dst", "edge_mask", "edge_feat", "targets",
            "node_mask", "graph_ids", "wigner_lut"]
    _assert_specs_equal(pol.gnn_input_specs(mesh, keys), ref_pol.gnn_input_specs(mesh, keys))
    _assert_specs_equal(pol.gnn_input_specs(mesh, keys[2:4]),
                        ref_pol.gnn_input_specs(mesh, keys[2:4]))
    _assert_specs_equal(pol.recsys_input_specs(mesh), ref_pol.recsys_input_specs(mesh))


def test_mesh_shapes_are_the_production_layouts():
    assert pol.SINGLE_POD.shape == {"data": 16, "model": 16}
    assert pol.MULTI_POD.shape == {"pod": 2, "data": 16, "model": 16}
    assert pol.dp_axes(pol.SINGLE_POD) == ("data",)
    assert pol.batch_spec(pol.SINGLE_POD) == ("data", None)  # PartitionSpec's canonical form
    assert pol.batch_spec(pol.MULTI_POD) == (("pod", "data"), None)


def test_lm_param_spec_per_leaf_equals_reference():
    leaves = ["embed", "head", "ln_f", "layers/ln1", "layers/wq", "layers/wo", "layers/w2",
              "layers/router", "layers/moe/w1", "layers/moe/w2", "layers/moe/router", "other"]
    for path in leaves:
        for mode in ("expert", "tp"):
            assert pol.lm_param_spec(path, (2, 3), mode) == tuple(
                ref_pol.lm_param_spec(path, (2, 3), mode)), (path, mode)


def test_shard_hint_returns_its_input():
    x = torch.arange(6).reshape(2, 3)
    assert shard_hint(x, "dp", None) is x and shard_hint(x) is x
