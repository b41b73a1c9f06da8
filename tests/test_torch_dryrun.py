"""The port's device mesh, ``named()``, the placing ``shard_hint``, the
abstract input specs and the dry run (``repro_torch.launch.{mesh,dryrun}``)
against the reference's: mesh shapes and axis names, every cell's abstract
inputs (``ShapeDtypeStruct``s), every arch's parameter tree (``jax.eval_shape``
of its init), every argument's local shard shape on both production meshes
(``NamedSharding(AbstractMesh(...), spec).shard_shape``), and the
``retrieval_cand`` records (the reference's dry run in a subprocess, since
it sets a 512-device XLA flag before JAX starts)."""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from repro import configs as ref_configs
from repro.distributed import policies as ref_pol
from repro.launch import mesh as ref_mesh_mod
from repro.models import gnn as ref_gnn
from repro.models.recsys import wide_deep as ref_wd
from repro.models.transformer import model as ref_tm
from repro.training.loop import make_train_step as ref_make_train_step
from repro.training.optimizer import AdamWConfig as RefAdamW
from repro_torch import configs
from repro_torch.configs.common import ShapeSpec
from repro_torch.distributed import policies as pol
from repro_torch.distributed.constraints import active_mesh, shard_hint, zeros_hint
from repro_torch.launch import dryrun, mesh as mesh_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [(a, s) for a in configs.ARCH_IDS for s in configs.get_config(a).shapes]
MESHES = {False: ((16, 16), ("data", "model")), True: ((2, 16, 16), ("pod", "data", "model"))}


def _by_path(tree, prefix=""):
    """'/'-joined path -> leaf of a nested dict/list/tuple tree (a
    ``PartitionSpec`` or a placement tuple of names is a leaf)."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _by_path(sub, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return {p: v for i, sub in enumerate(tree) for p, v in _by_path(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


def _is_spec(x) -> bool:
    return isinstance(x, P) or (isinstance(x, tuple) and all(
        e is None or isinstance(e, str) or (isinstance(e, tuple) and all(
            isinstance(n, str) for n in e)) for e in x))


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


# ---------------------------------------------------------------- (a) ----
@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh_matches_the_reference(multi_pod):
    sizes, names = MESHES[multi_pod]
    with dryrun._fake_world(int(np.prod(sizes))):
        m = mesh_mod.make_production_mesh(multi_pod=multi_pod)
        assert tuple(m.shape) == sizes and tuple(m.mesh_dim_names) == names
        assert pol.MeshShape.of(m) == (pol.MULTI_POD if multi_pod else pol.SINGLE_POD)
    assert not dist.is_initialized()
    # the reference's shapes and names (its mesh needs 256 devices to build)
    src = open(ref_mesh_mod.__file__).read()
    assert f"shape = (2, 16, 16) if multi_pod else (16, 16)" in src
    assert f'axes = ("pod", "data", "model") if multi_pod else ("data", "model")' in src
    for name in ("PEAK_FLOPS_BF16", "HBM_BW", "ICI_BW"):  # the roofline reader's names
        assert hasattr(ref_mesh_mod, name)
    assert (mesh_mod.PEAK_FLOPS_BF16, mesh_mod.HBM_BW, mesh_mod.ICI_BW) == (989e12, 3.35e12, 50e9)


# ---------------------------------------------------------------- (b) ----
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_abstract_inputs_match_the_reference(arch, shape_name):
    """Every cell's abstract inputs: meta tensors of the reference's
    ``ShapeDtypeStruct`` shapes and dtypes, key for key; the documented
    skips raise."""
    if configs.get_config(arch).shapes[shape_name].kind == "skip":
        with pytest.raises(ValueError, match="documented skip"):
            configs.input_specs(arch, shape_name)
        with pytest.raises(ValueError, match="documented skip"):
            ref_configs.input_specs(arch, shape_name)
        return
    got = configs.input_specs(arch, shape_name)
    want = ref_configs.input_specs(arch, shape_name)
    assert list(got) == list(want)
    for k, x in got.items():
        assert x.device.type == "meta", k
        assert (tuple(x.shape), _dtype(x)) == (tuple(want[k].shape), str(want[k].dtype)), k


# ---------------------------------------------------------------- (c) ----
def _cell_cfgs():
    """(arch, shape, effective config) for every distinct (arch, config)."""
    out, seen = [], set()
    for arch, shape_name in CELLS:
        spec = configs.get_config(arch)
        shape = spec.shapes[shape_name]
        if shape.kind == "skip":
            continue
        cfg = configs.effective_model_cfg(spec, shape)
        key = (arch, repr(cfg))
        if key not in seen:
            seen.add(key)
            out.append((arch, shape_name))
    return out


@functools.lru_cache(maxsize=None)
def _ref_params(arch, shape_name):
    spec = ref_configs.get_config(arch)
    cfg = ref_configs.effective_model_cfg(spec, spec.shapes[shape_name])
    init = {"lm": ref_tm.init_params, "gnn": ref_gnn.init_gnn,
            "recsys": ref_wd.init_wide_deep}[spec.family]
    return jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch,shape_name", _cell_cfgs())
def test_fake_parameter_tree_matches_eval_shape(arch, shape_name):
    """The port's init under fake mode at the full config against the
    reference's ``jax.eval_shape`` of its init: every leaf's shape and
    dtype, path for path."""
    spec = configs.get_config(arch)
    got = _by_path(dryrun.param_shapes(spec, configs.effective_model_cfg(
        spec, spec.shapes[shape_name])))
    want = _by_path(_ref_params(arch, shape_name))
    assert set(got) == set(want)
    for path, x in got.items():
        assert (tuple(x.shape), _dtype(x)) == (tuple(want[path].shape),
                                               str(want[path].dtype)), path


# ---------------------------------------------------------------- (d) ----
def _ref_args_specs(arch, shape_name, amesh):
    """The reference dry run's (arguments, specs) of a cell, as its
    ``build_lm`` / ``build_gnn`` / ``build_recsys`` make them (rebuilt here
    from its policies: importing its dry run would set a 512-device flag)."""
    spec = ref_configs.get_config(arch)
    shape = spec.shapes[shape_name]
    cfg = ref_configs.effective_model_cfg(spec, shape)
    inputs = ref_configs.input_specs(arch, shape_name)
    dp = ref_pol.dp_axes(amesh)

    def state(params_shape, psp):
        return _ref_state(arch, shape_name), {"params": psp, "opt": {"m": psp, "v": psp,
                                                                     "step": P()}}

    if spec.family == "lm":
        params = _ref_params(arch, shape_name)
        psp = ref_pol.lm_param_specs(params, moe_mode=cfg.moe.shard_mode if cfg.moe else "expert")
        if shape.kind == "train":
            st, sts = state(params, psp)
            return (st, inputs), (sts, {"tokens": P(dp, None), "loss_mask": P(dp, None)})
        if shape.kind == "prefill":
            b = ref_pol.batch_axes_or_none(amesh, shape.params["global_batch"])
            return (params, inputs["tokens"], inputs["true_len"]), (psp, P(b, None), P(b))
        batch = shape.params["global_batch"]
        cs = ref_pol.lm_cache_specs(amesh, batch, cfg.n_kv_heads)
        b = ref_pol.batch_axes_or_none(amesh, batch)
        return ((params, inputs["cache_k"], inputs["cache_v"], inputs["cache_pos"],
                 inputs["cursor"], inputs["token"]),
                (psp, cs["k"], cs["v"], cs["pos"], cs["cursor"], P(b)))
    if spec.family == "gnn":
        params = _ref_params(arch, shape_name)
        st, sts = state(params, ref_pol.gnn_param_specs(params))
        return (st, inputs), (sts, ref_pol.gnn_input_specs(amesh, inputs.keys()))
    rs = ref_pol.recsys_input_specs(amesh)
    if shape.kind == "retrieval":
        return (inputs["query"], inputs["cand_emb"]), (rs["query"], rs["cand_emb"])
    params = _ref_params(arch, shape_name)
    psp = ref_pol.recsys_param_specs(params)
    if shape.kind == "train":
        st, sts = state(params, psp)
        return (st, inputs), (sts, {k: rs[k] for k in ("dense", "sparse_ids", "labels")})
    return (params, inputs["dense"], inputs["sparse_ids"]), (psp, rs["dense"], rs["sparse_ids"])


@functools.lru_cache(maxsize=None)
def _ref_state(arch, shape_name):
    init_state, _ = ref_make_train_step(lambda p, b: (0.0, {}), RefAdamW())
    return jax.eval_shape(init_state, _ref_params(arch, shape_name))


def _port_shards(arch, shape_name, mesh) -> dict:
    spec = configs.get_config(arch)
    shape = spec.shapes[shape_name]
    cfg = configs.effective_model_cfg(spec, shape)
    builder = {"lm": dryrun.build_lm, "gnn": dryrun.build_gnn,
               "recsys": dryrun.build_recsys}[spec.family]
    _, args, specs, _ = builder(spec, shape, mesh, cfg)
    got_args, got_specs = _by_path(list(args)), _by_path(list(specs))
    assert set(got_args) == set(got_specs)
    return {path: (tuple(x.shape), tuple(compute_local_shape_and_global_offset(
        tuple(x.shape), mesh, pol.named(mesh, got_specs[path]))[0]))
            for path, x in got_args.items()}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_named_shards_match_named_sharding(multi_pod):
    """Every argument of every cell (parameters, optimizer state, inputs,
    caches) placed by ``named()`` on the port's mesh: rank 0's local shape
    equals ``NamedSharding(AbstractMesh, spec).shard_shape`` of the
    reference's spec for the same leaf."""
    sizes, names = MESHES[multi_pod]
    amesh = AbstractMesh(sizes, names)
    n = 0
    with dryrun._fake_world(int(np.prod(sizes))):
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
        for arch, shape_name in CELLS:
            if configs.get_config(arch).shapes[shape_name].kind == "skip":
                continue
            got = _port_shards(arch, shape_name, mesh)
            args, specs = _ref_args_specs(arch, shape_name, amesh)
            want_args, want_specs = _by_path(list(args)), _by_path(list(specs))
            assert set(got) == set(want_args), (arch, shape_name)
            for path, (shape, local) in got.items():
                x, s = want_args[path], want_specs[path]
                assert shape == tuple(x.shape), (arch, shape_name, path)
                assert local == tuple(NamedSharding(amesh, s).shard_shape(tuple(x.shape))), \
                    (arch, shape_name, path, s)
                n += 1
    assert n > 1000


_NESTED = """
import json, jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
out = {}
for name, spec in {"dp": P(("pod", "data"), None), "dp_model": P(("pod", "data"), "model"),
                   "model_dp": P("model", ("pod", "data"))}.items():
    idx = NamedSharding(mesh, spec).devices_indices_map((8, 12))
    out[name] = {str(d.id): [[s.start or 0, 12 if s.stop is None and i else 8 if s.stop is None
                              else s.stop] for i, s in enumerate(sl)] for d, sl in idx.items()}
print(json.dumps(out))
"""


def test_nested_shards_give_each_rank_the_reference_rows():
    """The ``("pod", "data")`` trap: DTensor nests the two ``Shard(0)`` in
    mesh order; each rank's (offset, shape) equals the slice JAX's
    ``NamedSharding`` gives the device at the same mesh position (device id
    = rank on a row-major mesh), on a 2 x 2 x 2 mesh of 8 host devices."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", _NESTED], capture_output=True, text=True,
                         timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    specs = {"dp": (("pod", "data"), None), "dp_model": (("pod", "data"), "model"),
             "model_dp": ("model", ("pod", "data"))}
    for rank in (0, 3, 5, 7):
        dist.init_process_group("fake", store=_fake_store(), rank=rank, world_size=8)
        try:
            mesh = mesh_mod.make_mesh((2, 2, 2), ("pod", "data", "model"))
            for name, spec in specs.items():
                shape, offset = compute_local_shape_and_global_offset(
                    (8, 12), mesh, pol.named(mesh, spec))
                got = [[o, o + s] for o, s in zip(offset, shape)]
                assert got == want[name][str(rank)], (rank, name, got)
        finally:
            dist.destroy_process_group()


def _fake_store():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    return FakeStore()


def test_named_rejects_axes_out_of_mesh_order_and_replicates_size_one_axes():
    with dryrun._fake_world(4):
        mesh = mesh_mod.make_mesh((4, 1), ("data", "model"))
        from torch.distributed.tensor import Replicate, Shard

        assert pol.named(mesh, ("data", "model")) == (Shard(0), Replicate())
        assert pol.named(mesh, ((), None)) == (Replicate(), Replicate())
        with pytest.raises(ValueError, match="mesh order"):
            pol.named(mesh, (("model", "data"),))
        with pytest.raises(ValueError, match="once"):
            pol.named(mesh, ("data", "data"))


# ---------------------------------------------------------------- (e) ----
def test_shard_hint_is_the_identity_without_a_mesh():
    x = torch.randn(4, 6)
    bits = x.clone()
    assert shard_hint(x, "dp", "model") is x and torch.equal(x, bits)
    z = zeros_hint((3, 5), None, "model", dtype=torch.bfloat16)
    assert type(z) is torch.Tensor and z.dtype == torch.bfloat16 and not z.any()


@pytest.mark.parametrize("multi_pod", [False, True])
def test_shard_hint_places_under_a_mesh(multi_pod):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    sizes, names = MESHES[multi_pod]
    with dryrun._fake_world(int(np.prod(sizes))):
        mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
        x = DTensor.from_local(torch.randn(64, 32), mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
        plain = torch.randn(8)
        with active_mesh(mesh):
            y = shard_hint(x, "dp", "model")  # Replicate -> Shard: a local chunk
            z = shard_hint(x, None, "nope")  # a name the mesh lacks: replicated
            assert shard_hint(plain, "dp") is plain  # not a DTensor: unchanged
            w = zeros_hint((64, 32), None, "model", dtype=torch.float32)
        assert shard_hint(x, "dp", "model") is x  # the mesh is gone again
    dp = len(sizes) - 1
    assert tuple(y.placements) == (Shard(0),) * dp + (Shard(1),)
    assert tuple(y.to_local().shape) == (64 // int(np.prod(sizes[:-1])), 2)
    assert torch.equal(y.to_local(), x.to_local()[:y.to_local().shape[0], :2])
    assert tuple(z.placements) == (Replicate(),) * len(sizes)
    assert tuple(w.to_local().shape) == (64, 2) and tuple(w.shape) == (64, 32)
    assert not w.to_local().any()


# ---------------------------------------------------------------- (f) ----
_REF_RECORDS = """
import json
from repro.launch.dryrun import run_cell
recs = [run_cell('wide-deep', 'retrieval_cand', multi_pod=mp, skip_analysis=True)
        for mp in (False, True)]
print('RECS=' + json.dumps(recs))
"""


@pytest.fixture(scope="module")
def ref_retrieval_records():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _REF_RECORDS], capture_output=True, text=True,
                         timeout=420, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RECS=")][-1]
    return json.loads(line[len("RECS="):])


@pytest.mark.parametrize("multi_pod", [False, True])
def test_retrieval_cand_record_equals_the_reference(multi_pod, ref_retrieval_records):
    ref = ref_retrieval_records[int(multi_pod)]
    rec = dryrun.run_cell("wide-deep", "retrieval_cand", multi_pod=multi_pod)
    assert rec["status"] == ref["status"] == "ok"
    assert rec["mesh"] == ref["mesh"] and rec["n_devices"] == ref["n_devices"]
    assert rec["memory"]["argument_bytes"] == ref["memory"]["argument_bytes"] == 64_001_024
    assert rec["cost_full_program"]["flops"] == ref["cost_full_program"]["flops"] == 32_000_000
    assert set(rec["collectives_full_program"]) == set(ref["collectives_full_program"])
    assert rec["collectives_full_program"] == ref["collectives_full_program"]
    assert set(rec) >= {"arch", "shape", "mesh", "kind", "status", "memory", "cost_full_program",
                        "collectives_full_program", "fit_per_device", "n_devices",
                        "compile_s_full", "compile_s_total"}
    assert set(rec["memory"]) == set(ref["memory"])
    assert rec["fit_per_device"]["flops"] == 32_000_000


# ---------------------------------------------------------------- (g) ----
def _tiny_lm(monkeypatch, b=4, s=64, kind="train", **over):
    spec = configs.get_config("starcoder2-3b")
    cfg = dataclasses.replace(spec.reduced_cfg, vocab=512, **over)
    tiny = dataclasses.replace(spec, model_cfg=cfg, shapes={
        "tiny": ShapeSpec("tiny", kind, dict(seq_len=s, global_batch=b))})
    monkeypatch.setitem(configs.REGISTRY, "starcoder2-3b", tiny)
    return cfg


def test_reduced_lm_train_flops_equal_the_analytic_count(monkeypatch):
    """A train step of a reduced StarCoder2 (no remat, one micro-batch, dense
    attention) on a 1 x 1 mesh: forward matmuls (projections, S x S scores
    and P V over every pair, SwiGLU, the head over S - 1 positions) and
    twice that in the backward."""
    b, s = 4, 64
    monkeypatch.setenv("REPRO_N_MICRO", "1")
    cfg = _tiny_lm(monkeypatch, b, s)
    rec = dryrun.run_cell("starcoder2-3b", "tiny", mesh_shape=(1, 1))
    d, h, kv, dh, f, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff,
                          cfg.vocab)
    layer = (2 * b * s * d * (h + 2 * kv) * dh + 2 * b * s * h * dh * d
             + 2 * 2 * b * h * s * s * dh + 3 * 2 * b * s * d * f)
    fwd = cfg.n_layers * layer + 2 * b * (s - 1) * d * v
    assert rec["status"] == "ok"
    assert rec["fit_per_device"]["flops"] == 3 * fwd
    # the full config (remat) recomputes each layer's forward in the
    # backward, up to its last saved tensor: the FFN's w2 product, whose
    # output nothing saves, is not rerun (non-reentrant checkpoint stops early)
    assert cfg.remat
    assert rec["cost_full_program"]["flops"] == 3 * fwd + cfg.n_layers * (layer - 2 * b * s * f * d)
    assert rec["collectives_full_program"] == {"total": 0}


def test_reduced_lm_decode_on_the_production_mesh(monkeypatch):
    """A reduced decode cell on 16 x 16: it runs, the cache it updates in
    place comes back aliased, collectives move bytes, and rank 0's FLOPs
    are below the whole step's (the same cell on a 1 x 1 mesh)."""
    _tiny_lm(monkeypatch, 32, 64, kind="decode")
    one = dryrun.run_cell("starcoder2-3b", "tiny", mesh_shape=(1, 1), skip_analysis=True)
    rec = dryrun.run_cell("starcoder2-3b", "tiny", skip_analysis=True)
    assert rec["status"] == one["status"] == "ok" and rec["n_devices"] == 256
    for r in (one, rec):
        mem = r["memory"]
        assert mem["alias_bytes"] > 0 and mem["per_device_total"] >= mem["argument_bytes"]
    assert 0 < rec["cost_full_program"]["flops"] < one["cost_full_program"]["flops"]
    assert rec["memory"]["argument_bytes"] < one["memory"]["argument_bytes"]
    assert rec["collectives_full_program"]["total"] > 0 == one["collectives_full_program"]["total"]
    assert rec["replicated_ops"].get("aten.index_put_.default", 0) > 0  # the cache writes


def test_reduced_lm_prefill_cache_is_made_sharded(monkeypatch):
    """A reduced prefill on 16 x 16 makes its cache with ``zeros_hint``:
    rank 0's cache (the output) is its shard, (batch / 16) x (length / 16)
    of the whole, and no whole-size placeholder is counted on the way."""
    cfg = _tiny_lm(monkeypatch, 32, 256, kind="prefill", n_layers=8)
    one = dryrun.run_cell("starcoder2-3b", "tiny", mesh_shape=(1, 1), skip_analysis=True)
    rec = dryrun.run_cell("starcoder2-3b", "tiny", skip_analysis=True)
    cache = 2 * cfg.n_layers * 32 * 256 * cfg.n_kv_heads * cfg.d_head * 4  # k and v, fp32
    assert one["memory"]["output_bytes"] >= cache
    assert rec["memory"]["output_bytes"] < one["memory"]["output_bytes"] / 100
    assert rec["memory"]["per_device_total"] < cache / 3


# EquiformerV2 at ``molecule`` (one edge chunk a layer) as the dry run counted
# it when it sliced the edge arrays, its forward alone (the full steps take
# ~20 s and ~107 s here, past this file's budget; their records' pins are in
# PERF.md): (FLOPs, argument bytes, per-device total) on each production mesh.
_EQUI_FORWARD_PINS = {False: (145_103_192_064, 450_486_884, 1_257_384_948),
                      True: (77_889_994_752, 450_482_276, 1_172_036_068)}


def _forward_only(monkeypatch):
    """Cells' train steps become their loss alone (the forward)."""
    import repro_torch.training as training

    monkeypatch.setattr(training, "make_train_step", lambda loss_fn, opt_cfg, **kw: (
        None, lambda state, batch: loss_fn(state["params"], batch)[0]))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_equiformer_molecule_counts_are_pinned(multi_pod, monkeypatch):
    """Reading the edge arrays chunk by chunk from each rank's own rows
    changes no count of a one-chunk cell: FLOPs, argument bytes and the
    per-device total equal what the dry run gave when it sliced them."""
    _forward_only(monkeypatch)
    rec = dryrun.run_cell("equiformer-v2", "molecule", multi_pod=multi_pod, skip_analysis=True)
    assert rec["status"] == "ok"
    assert (rec["cost_full_program"]["flops"], rec["memory"]["argument_bytes"],
            rec["memory"]["per_device_total"]) == _EQUI_FORWARD_PINS[multi_pod]


def test_equiformer_chunks_read_each_ranks_own_rows(monkeypatch):
    """Four edge chunks a layer instead of one (the forward on 16 x 16): the
    one-chunk forward's FLOPs, every chunk built from rank 0's own rows, and
    no full edge array all-gathered (DTensor's slice of the row-sharded
    array would gather all 16,384 rows for every chunk)."""
    _forward_only(monkeypatch)
    built, gathered = [], []
    make, dispatch = dryrun._ChunkRows.__getitem__, dryrun._Count._dispatch

    def recording(self, func, types, args, kwargs):
        out = dispatch(self, func, types, args, kwargs)
        if "all_gather_into_tensor" in str(func) and isinstance(out, torch.Tensor):
            gathered.append(tuple(out.shape))
        return out

    monkeypatch.setattr(dryrun._ChunkRows, "__getitem__",
                        lambda self, span: built.append(span.start) or make(self, span))
    monkeypatch.setattr(dryrun._Count, "_dispatch", recording)
    rec = dryrun.run_cell("equiformer-v2", "molecule", skip_analysis=True, edge_chunk=4096)
    assert rec["status"] == "ok"
    assert rec["cost_full_program"]["flops"] == _EQUI_FORWARD_PINS[False][0]
    assert set(built) == {0, 4096, 8192, 12288} and gathered
    assert not [s for s in gathered if s[0] == 16_384], gathered


# ---------------------------------------------------------------- (h) ----
def test_no_process_group_outlives_a_cell(monkeypatch):
    assert not dist.is_initialized()
    rec = dryrun.run_cell("wide-deep", "serve_p99", mesh_shape=(1, 1))
    assert rec["status"] == "ok" and not dist.is_initialized()
    assert dryrun.run_cell("granite-moe-1b-a400m", "long_500k")["status"] == "skip"

    def boom(*a, **kw):
        raise RuntimeError("a builder that fails")

    monkeypatch.setattr(dryrun, "build_recsys", boom)
    with pytest.raises(RuntimeError, match="fails"):
        dryrun.run_cell("wide-deep", "serve_p99")
    assert not dist.is_initialized()


def test_main_writes_records_and_caches(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "build_gnn", lambda *a, **kw: 1 / 0)
    argv = ["--arch", "gin-tu", "--shape", "molecule", "--out", str(tmp_path)]
    dryrun.main(argv)
    rec = json.loads((tmp_path / "gin-tu__molecule__sp.json").read_text())
    assert rec["status"] == "error" and "ZeroDivisionError" in rec["error"]
    dryrun.main(argv)
    assert "[cached] gin-tu__molecule__sp" in capsys.readouterr().out
    assert not dist.is_initialized()
