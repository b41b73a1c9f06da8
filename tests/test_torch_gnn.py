"""The port's GNN zoo (``repro_torch.models.gnn``), its configs, input
builders, graph utilities and the launcher's gnn branch against the
reference on the CPU, with the reference's weights carried over and the same
seeded numpy inputs.

Tolerances:
- forward values and losses ``rtol=1e-5`` plus ``1e-5 * max|ref|``
  absolute: fp32 on both sides, the same arithmetic in another summation
  order (ATen against XLA), so a value near zero is held to the scale of its
  tensor;
- gradients ``rtol=1e-4`` plus ``1e-4 * max|ref|`` of the leaf: the backward
  compounds the forward's last-bit differences through every layer; the
  absolute part is at least 1e-7, since a leaf whose exact gradient is zero
  (the attention logits' last bias in EquiformerV2: the softmax is
  shift-invariant per head) holds only rounding noise, ~1e-8 on both sides;
- train-step losses ``rtol=1e-4``: the step's loss is computed before its
  update, and three AdamW updates move the weights by at most ``lr`` a step;
- integer outputs exact: direction bins, dropped ids, the Wigner LUT and
  ``m_index_sets`` (same NumPy code), ``concretize`` arrays (same seed and
  draw order), the sampler's blocks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import common as ref_common
from repro.graph import batch as ref_batch
from repro.graph import generators as ref_generators
from repro.graph import sampler as ref_sampler
from repro.models import gnn as ref_gnn
from repro.models.gnn import GNNConfig as RefGNNConfig
from repro.models.gnn import equiformer as ref_equi
from repro.models.gnn import wigner as ref_wigner
from repro.training import loop as ref_loop
from repro.training import optimizer as ref_opt
from repro_torch import configs
from repro_torch.configs import common
from repro_torch.graph import batch, generators, sampler
from repro_torch.launch import train as train_launch
from repro_torch.models import gnn
from repro_torch.models.gnn import GNNConfig, common as gcommon, equiformer, wigner
from repro_torch.training import loop, optimizer
from repro_torch.tree import tree_leaves, tree_map

ARCHS = {"gin": "gin-tu", "meshgraphnet": "meshgraphnet", "graphcast": "graphcast",
         "equiformer_v2": "equiformer-v2"}


def _close(got, want, rel, floor=0.0):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rel, atol=max(rel * scale, floor))


def _close_grads(g_b, g_a):
    flat_a = jax.tree.leaves(jax.tree.map(np.asarray, g_a))
    flat_b = tree_leaves(g_b)
    assert len(flat_a) == len(flat_b)
    for ga, gb in zip(flat_a, flat_b):
        _close(gb, ga, 1e-4, floor=1e-7)


def _cfgs(arch):
    """(reference config, port config): the registry's reduced config."""
    ref_cfg = ref_configs.get_config(ARCHS[arch]).reduced_cfg
    return ref_cfg, GNNConfig(**dataclasses.asdict(ref_cfg))


def _params(arch, seed=0):
    ref_cfg, cfg = _cfgs(arch)
    ref_params = ref_gnn.init_gnn(jax.random.PRNGKey(seed), ref_cfg)
    return ref_cfg, ref_params, cfg, gnn.params_from_jax(jax.tree.map(np.asarray, ref_params),
                                                         device="cpu")


def _graph_inputs(cfg, n=40, seed=3, pad=0, readout=False):
    """numpy inputs on a seeded citation graph; ``pad`` extra masked edges
    cycling through the three padding forms (dst = n, dst = -1 with src =
    -1, and src = n with dst = -1)."""
    g = ref_generators.citation_graph(n, avg_deg=4, d_feat=cfg.d_in, seed=seed)
    src, dst = g.edge_list()
    e = len(src)
    rng = np.random.default_rng(seed)
    forms = [(0, n), (-1, -1), (n, -1)]
    ps = np.array([forms[i % 3][0] for i in range(pad)], np.int32)
    pd = np.array([forms[i % 3][1] for i in range(pad)], np.int32)
    # a padded src that is a real node too: masked, it must still add nothing
    if pad:
        ps[0] = 1
    inp = {
        "node_feat": g.node_feat.astype(np.float32),
        "edge_src": np.concatenate([src, ps]).astype(np.int32),
        "edge_dst": np.concatenate([dst, pd]).astype(np.int32),
        "edge_mask": np.concatenate([np.ones(e, bool), np.zeros(pad, bool)]),
    }
    if cfg.arch == "equiformer_v2":
        inp["pos"] = rng.standard_normal((n, 3)).astype(np.float32)
        inp["wigner_lut"] = ref_wigner.build_wigner_lut(cfg.l_max, n_theta=8, n_phi=16,
                                                        n_samples=64)
    if readout:
        inp["targets"] = rng.standard_normal((4, cfg.d_out)).astype(np.float32)
        inp["graph_ids"] = rng.integers(0, 6, n).astype(np.int32)  # 4, 5 out of range
    else:
        inp["targets"] = rng.standard_normal((n, cfg.d_out)).astype(np.float32)
        inp["node_mask"] = (rng.random(n) < 0.7).astype(np.float32)
    return inp


def _both(inp):
    return ({k: jnp.asarray(v) for k, v in inp.items()},
            {k: torch.from_numpy(np.array(v)) for k, v in inp.items()})


def _pad_to(inp, e_total):
    """Pad the edge arrays with masked (n, n) edges to ``e_total``."""
    n = inp["node_feat"].shape[0]
    pad = e_total - len(inp["edge_src"])
    out = dict(inp)
    out["edge_src"] = np.concatenate([inp["edge_src"], np.full(pad, n, np.int32)])
    out["edge_dst"] = np.concatenate([inp["edge_dst"], np.full(pad, n, np.int32)])
    out["edge_mask"] = np.concatenate([inp["edge_mask"], np.zeros(pad, bool)])
    return out


def _port_grads(params, cfg, inputs):
    grads = tree_map(torch.zeros_like, params)
    loss = gnn.gnn_loss(loop.train_view(params, grads), cfg, inputs)
    loss.backward()
    return loss, grads


# ----------------------------------------------------------- forward/grad --
@pytest.mark.parametrize("arch", list(ARCHS))
def test_apply_loss_and_grads_match(arch):
    ref_cfg, ref_params, cfg, params = _params(arch)
    inp = _graph_inputs(cfg, pad=5)
    a, b = _both(inp)
    _close(gnn.apply_gnn(params, cfg, b), ref_gnn.apply_gnn(ref_params, ref_cfg, a), 1e-5)
    loss_a, g_a = jax.value_and_grad(ref_gnn.gnn_loss)(ref_params, ref_cfg, a)
    loss_b, g_b = _port_grads(params, cfg, b)
    _close(loss_b, loss_a, 1e-5)
    _close_grads(g_b, g_a)
    if arch == "gin":  # eps is a 0-d leaf with its own gradient
        assert params["layers"][0]["eps"].ndim == 0 and g_b["layers"][0]["eps"].ndim == 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_padded_edges_are_no_ops(arch):
    """Masked edges (dst = n, dst = -1 with src = -1 or n, and one with a
    real src) change nothing, in the port as in the reference."""
    ref_cfg, ref_params, cfg, params = _params(arch)
    plain, padded = _graph_inputs(cfg), _graph_inputs(cfg, pad=7)
    if arch == "equiformer_v2":  # edge counts must fill whole chunks
        e = len(padded["edge_src"])
        plain, padded = _pad_to(plain, e), _pad_to(padded, e)
    assert (padded["edge_dst"] == -1).any()
    out = {}
    for name, inp in (("plain", plain), ("padded", padded)):
        a, b = _both(inp)
        out[name] = gnn.apply_gnn(params, cfg, b)
        _close(out[name], ref_gnn.apply_gnn(ref_params, ref_cfg, a), 1e-5)
    _close(out["padded"], out["plain"].detach().numpy(), 1e-6)


def test_scatters_drop_and_wrap_as_jax():
    """The three index rules on a crafted id vector, against JAX itself."""
    data = np.arange(12, dtype=np.float32).reshape(6, 2) + 1
    ids = np.array([0, -1, 3, 4, -6, 2], np.int32)
    d_t, i_t = torch.from_numpy(data), torch.from_numpy(ids)
    np.testing.assert_array_equal(gcommon.segment_sum(d_t, i_t, 4).numpy(),
                                  jax.ops.segment_sum(data, ids, num_segments=4))
    np.testing.assert_array_equal(gcommon.segment_max(d_t, i_t, 4).numpy(),
                                  jax.ops.segment_max(data, ids, num_segments=4))
    buf = np.full((4, 2), 0.5, np.float32)
    np.testing.assert_array_equal(gcommon.at_add(torch.from_numpy(buf), i_t, d_t).numpy(),
                                  jnp.asarray(buf).at[ids].add(data))
    np.testing.assert_array_equal(gcommon.at_max(torch.from_numpy(buf), i_t, d_t).numpy(),
                                  jnp.asarray(buf).at[ids].max(data))
    h = np.arange(10, dtype=np.float32).reshape(5, 2)
    gi = np.array([-1, -7, 9, 2], np.int32)
    np.testing.assert_array_equal(gcommon.take(torch.from_numpy(h), torch.from_numpy(gi)).numpy(),
                                  jnp.asarray(h)[gi])
    # scatter_sum with dst = -1 on an unmasked edge: dropped, no error
    msg = torch.ones(3, 2)
    out = gcommon.scatter_sum(msg, torch.tensor([0, -1, 1], dtype=torch.int32), 2)
    np.testing.assert_array_equal(out.numpy(), ref_gnn.common.scatter_sum(
        jnp.ones((3, 2)), jnp.asarray([0, -1, 1], jnp.int32), 2))
    np.testing.assert_array_equal(out.numpy(), [[1, 1], [1, 1]])


@pytest.mark.parametrize("aggregator", ["mean", "sum"])
def test_scatter_mean_and_segment_softmax(aggregator):
    rng = np.random.default_rng(0)
    msg = rng.standard_normal((9, 3)).astype(np.float32)
    dst = np.array([0, 0, 2, -1, 5, 2, 1, 5, 3], np.int32)
    mask = np.array([1, 1, 1, 1, 0, 1, 0, 1, 1], bool)
    a = (jnp.asarray(msg), jnp.asarray(dst), 5, jnp.asarray(mask))
    b = (torch.from_numpy(msg), torch.from_numpy(dst), 5, torch.from_numpy(mask))
    fn = "scatter_mean" if aggregator == "mean" else "scatter_sum"
    _close(getattr(gcommon, fn)(*b), getattr(ref_gnn.common, fn)(*a), 1e-6)
    _close(gcommon.segment_softmax(*b), ref_gnn.common.segment_softmax(*a), 1e-6)


def test_graph_readout_drops_out_of_range_graph_ids():
    """Readout at 4 graphs with ids drawn in [0, 6): nodes of ids 4 and 5
    are dropped, in the port as in the reference."""
    ref_cfg, ref_params, cfg, params = _params("gin")
    ref_cfg = dataclasses.replace(ref_cfg, graph_readout=True)
    cfg = dataclasses.replace(cfg, graph_readout=True)
    inp = _graph_inputs(cfg, readout=True)
    assert (inp["graph_ids"] >= 4).any()
    a, b = _both(inp)
    loss_a, g_a = jax.value_and_grad(ref_gnn.gnn_loss)(ref_params, ref_cfg, a)
    loss_b, g_b = _port_grads(params, cfg, b)
    _close(loss_b, loss_a, 1e-5)
    _close_grads(g_b, g_a)
    out = gnn.apply_gnn(params, cfg, b).detach()
    keep = b["graph_ids"] < 4
    want = torch.zeros(4, cfg.d_out).index_add_(0, b["graph_ids"][keep], out[keep])
    _close(gnn.gnn_loss(params, cfg, b), torch.mean((want - b["targets"]) ** 2).numpy(), 1e-6)


# ------------------------------------------------------------- equiformer --
def _ref_bins(pos, src, dst, n, n_theta, n_phi):
    """The reference's binning lines (``equiformer.py:130-139``), eager."""
    pp = jnp.concatenate([pos, jnp.zeros((1, 3), pos.dtype)], 0)
    d_vec = pp[jnp.minimum(dst, n)] - pp[jnp.minimum(src, n)]
    dist = jnp.linalg.norm(d_vec, axis=-1)
    u = d_vec / jnp.maximum(dist, 1e-6)[:, None]
    theta = jnp.arccos(jnp.clip(u[:, 2], -1, 1))
    phi = jnp.arctan2(u[:, 1], u[:, 0])
    it = jnp.clip((theta / np.pi * n_theta).astype(jnp.int32), 0, n_theta - 1)
    ip = jnp.clip(((phi + np.pi) / (2 * np.pi) * n_phi).astype(jnp.int32), 0, n_phi - 1)
    return it * n_phi + ip


@pytest.mark.parametrize("n_theta", [8, 32])
def test_equiformer_bins_equal(n_theta):
    """Direction bins of 4,000 random edges (and of axis-aligned ones, at
    the poles and on the phi seam) equal the reference's."""
    rng = np.random.default_rng(n_theta)
    n = 500
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    pos[:6] = [[0, 0, 0], [0, 0, 1], [0, 0, -1], [-1, 0, 0], [-1, -1e-8, 0], [1, 0, 0]]
    src = np.concatenate([rng.integers(0, n, 4000), [0, 0, 0, 0, 0, 0]]).astype(np.int32)
    dst = np.concatenate([rng.integers(0, n, 4000), [1, 2, 3, 4, 5, -1]]).astype(np.int32)
    want = np.asarray(_ref_bins(jnp.asarray(pos), jnp.asarray(src), jnp.asarray(dst), n,
                                n_theta, 2 * n_theta))
    got, _ = equiformer.edge_geometry(torch.from_numpy(pos), torch.from_numpy(src),
                                      torch.from_numpy(dst), n, n_theta, 2 * n_theta)
    np.testing.assert_array_equal(got.numpy(), want)


def test_equiformer_edge_chunk_invariance():
    """edge_chunk E and E / 4 give the same outputs, in the port and against
    the reference at both."""
    ref_cfg, ref_params, cfg, params = _params("equiformer_v2")
    inp = _graph_inputs(cfg, pad=3)
    e = -(-len(inp["edge_src"]) // 4) * 4
    a, b = _both(_pad_to(inp, e))
    outs = []
    for chunk in (e, e // 4):
        outs.append(equiformer.apply_equiformer(params, cfg, b, edge_chunk=chunk))
        _close(outs[-1], ref_equi.apply_equiformer(ref_params, ref_cfg, a, edge_chunk=chunk),
               1e-5)
    _close(outs[1], outs[0].detach().numpy(), 1e-5)
    with pytest.raises(AssertionError):
        equiformer.apply_equiformer(params, cfg, b, edge_chunk=e // 4 + 1)


def test_wigner_lut_and_m_index_sets_bitwise():
    for l_max, nt, npf, ns in ((2, 8, 16, 64), (6, 4, 8, 512)):
        np.testing.assert_array_equal(wigner.build_wigner_lut(l_max, nt, npf, ns),
                                      ref_wigner.build_wigner_lut(l_max, nt, npf, ns))
    for l_max, m_max in ((2, 1), (6, 2), (3, 3)):
        got, want = wigner.m_index_sets(l_max, m_max), ref_wigner.m_index_sets(l_max, m_max)
        assert got.keys() == want.keys()
        for m in want:
            for x, y in zip(got[m], want[m]):
                assert x.dtype == y.dtype and np.array_equal(x, y)
    dirs = np.random.default_rng(1).standard_normal((300, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    np.testing.assert_array_equal(wigner.real_sph_harm(4, dirs), ref_wigner.real_sph_harm(4, dirs))
    np.testing.assert_array_equal(wigner.direction_bins(dirs, 8, 16),
                                  ref_wigner.direction_bins(dirs, 8, 16))


# ---------------------------------------------------------------- configs --
def test_registry_and_effective_configs_match():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    assert list(configs.REGISTRY) == list(ref_configs.REGISTRY)
    for arch, ref_spec in ref_configs.REGISTRY.items():
        spec = configs.get_config(arch)
        assert (spec.family, spec.source) == (ref_spec.family, ref_spec.source)
        assert list(spec.shapes) == list(ref_spec.shapes)
        for name, ref_shape in ref_spec.shapes.items():
            shape = spec.shapes[name]
            assert (shape.name, shape.kind, shape.params) == \
                (ref_shape.name, ref_shape.kind, ref_shape.params)
            if shape.kind == "skip":
                continue
            want = dataclasses.asdict(ref_configs.effective_model_cfg(ref_spec, ref_shape))
            got = dataclasses.asdict(configs.effective_model_cfg(spec, shape))
            assert got == want, (arch, name)
            if spec.family == "gnn":
                assert common.padded_edges(shape) == ref_common.padded_edges(ref_shape)
        for field in ("model_cfg", "reduced_cfg"):
            assert dataclasses.asdict(getattr(spec, field)) == \
                dataclasses.asdict(getattr(ref_spec, field))
    got = configs.input_specs("gin-tu", "molecule")  # abstract: meta tensors, no data
    want = ref_configs.input_specs("gin-tu", "molecule")
    assert list(got) == list(want)
    for k, x in got.items():
        assert x.device.type == "meta", k
        assert (tuple(x.shape), str(x.dtype).split(".")[-1]) == \
            (tuple(want[k].shape), str(want[k].dtype)), k


@pytest.mark.parametrize("arch", ["gin", "equiformer_v2"])
def test_concretize_gnn_arrays_equal(arch):
    """The reference's concrete inputs at a small shape of each kind
    (node-level, and graph readout at ``molecule``), array for array."""
    small = {"full_graph_sm": dict(n_nodes=40, n_edges=120, d_feat=13, d_out=3),
             "molecule": dict(n_nodes=5, n_edges=6, batch=4, d_feat=16, d_out=2)}
    spec, ref_spec = configs.get_config(ARCHS[arch]), ref_configs.get_config(ARCHS[arch])
    for name, params in small.items():
        ref_shape = ref_common.ShapeSpec(name, "train", params)
        shape = common.ShapeSpec(name, "train", params)
        cfg = configs.effective_model_cfg(dataclasses.replace(spec, model_cfg=spec.reduced_cfg),
                                          shape)
        ref_cfg = ref_configs.effective_model_cfg(
            dataclasses.replace(ref_spec, model_cfg=ref_spec.reduced_cfg), ref_shape)
        want = ref_common.gnn_inputs(ref_shape, ref_cfg, abstract=False)
        got = common.gnn_inputs(shape, cfg, abstract=False, device="cpu")
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            w = np.asarray(w)
            assert got[key].numpy().dtype == w.dtype and np.array_equal(got[key].numpy(), w), key


@pytest.mark.parametrize("name,kind,params", [
    ("train_4k", "train", dict(seq_len=16, global_batch=2)),
    ("prefill_32k", "prefill", dict(seq_len=16, global_batch=2)),
    ("decode_32k", "decode", dict(seq_len=8, global_batch=2))])
def test_concretize_lm_arrays_equal(name, kind, params):
    """The LM cells' concrete inputs (tokens below the padded vocab, an
    empty cache) at a small size, array for array."""
    spec, ref_spec = configs.get_config("starcoder2-3b"), ref_configs.get_config("starcoder2-3b")
    cfg = configs.effective_model_cfg(dataclasses.replace(spec, model_cfg=spec.reduced_cfg),
                                      spec.shapes[name])
    ref_cfg = ref_configs.effective_model_cfg(
        dataclasses.replace(ref_spec, model_cfg=ref_spec.reduced_cfg), ref_spec.shapes[name])
    want = ref_common.lm_inputs(ref_common.ShapeSpec(name, kind, params), ref_cfg, abstract=False)
    got = common.lm_inputs(common.ShapeSpec(name, kind, params), cfg, abstract=False,
                           device="cpu")
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w)
        assert str(got[key].dtype).split(".")[-1] == str(w.dtype) and \
            np.array_equal(got[key].float().numpy(), w.astype(np.float32)), key


# ---------------------------------------------------- batch, sampler, step --
def test_batch_graphs_and_sampler_match():
    mols = generators.molecule_graphs(5, 12, 20, d_feat=8, seed=2)
    ref_mols = ref_generators.molecule_graphs(5, 12, 20, d_feat=8, seed=2)
    big, gids = batch.batch_graphs(mols)
    ref_big, ref_gids = ref_batch.batch_graphs(ref_mols)
    for x, y in ((big.indptr, ref_big.indptr), (big.indices, ref_big.indices),
                 (big.node_feat, ref_big.node_feat), (gids, ref_gids)):
        assert np.array_equal(x, y) and x.dtype == y.dtype
    g = generators.citation_graph(400, avg_deg=6, d_feat=16, seed=5)
    ref_g = ref_generators.citation_graph(400, avg_deg=6, d_feat=16, seed=5)
    s, rs = sampler.NeighborSampler(g, (4, 3), seed=0), ref_sampler.NeighborSampler(ref_g, (4, 3))
    for seeds in (np.arange(16), np.array([3, 399, 7])):
        blk, rblk = s.sample(seeds), rs.sample(seeds)
        assert blk.n_valid == rblk.n_valid and s.capacity(16) == rs.capacity(16)
        for x, y in [(blk.nodes, rblk.nodes), (blk.seeds_pos, rblk.seeds_pos),
                     *zip(blk.hops, rblk.hops), *zip(blk.hop_masks, rblk.hop_masks)]:
            assert np.array_equal(x, y) and x.dtype == y.dtype


def _block_inputs(g, blk, d_out=4):
    """The reference test's sampled block as an edge list over the union's
    positions (``tests/test_gnn.py::test_sampled_block_trains_gnn``)."""
    srcs, dsts = [], []
    frontier_pos = blk.seeds_pos
    for h, m in zip(blk.hops, blk.hop_masks):
        fp = np.repeat(frontier_pos, h.shape[1]).reshape(h.shape)
        srcs.append(h[m])
        dsts.append(fp[m])
        frontier_pos = h.reshape(-1)
    src, dst = np.concatenate(srcs), np.concatenate(dsts)
    cap = len(blk.nodes)
    feat = np.zeros((cap, g.node_feat.shape[1]), np.float32)
    feat[: blk.n_valid] = g.node_feat[blk.nodes[: blk.n_valid]]
    mask = np.zeros(cap, np.float32)
    mask[blk.seeds_pos] = 1.0
    return {"node_feat": feat, "edge_src": src.astype(np.int32),
            "edge_dst": dst.astype(np.int32), "edge_mask": np.ones(len(src), bool),
            "targets": np.zeros((cap, d_out), np.float32), "node_mask": mask}


def test_sampled_block_gin_step_matches():
    """The reference's sampler-to-block GIN run: loss and gradients, then
    one train step, on the block the port's sampler draws."""
    g = generators.citation_graph(400, avg_deg=6, d_feat=16, seed=5)
    blk = sampler.NeighborSampler(g, (4, 3), seed=0).sample(np.arange(16))
    ref_cfg = RefGNNConfig(name="gin", arch="gin", n_layers=2, d_hidden=16, d_in=16, d_out=4)
    cfg = GNNConfig(**dataclasses.asdict(ref_cfg))
    ref_params = ref_gnn.init_gnn(jax.random.PRNGKey(0), ref_cfg)
    params = gnn.params_from_jax(jax.tree.map(np.asarray, ref_params), device="cpu")
    a, b = _both(_block_inputs(g, blk))
    loss_a, g_a = jax.value_and_grad(ref_gnn.gnn_loss)(ref_params, ref_cfg, a)
    loss_b, g_b = _port_grads(params, cfg, b)
    assert np.isfinite(loss_b.item())
    _close(loss_b, loss_a, 1e-5)
    _close_grads(g_b, g_a)


def _ref_train_losses(loss_a, ref_params, batches, kw):
    init_a, step_a = ref_loop.make_train_step(loss_a, ref_opt.AdamWConfig(**kw))
    state, step_a = init_a(ref_params), jax.jit(step_a)
    out = []
    for bt in batches:
        state, m = step_a(state, bt)
        out.append(float(m["loss"]))
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_steps_match(arch):
    """Three ``make_train_step`` steps (AdamW as the launcher sets it) on
    the reference's weights, against the reference's jitted step."""
    ref_cfg, ref_params, cfg, params = _params(arch)
    kw = dict(lr=1e-3, warmup_steps=5, total_steps=3)
    inp = _graph_inputs(cfg, pad=2)
    if arch == "equiformer_v2":
        inp = _pad_to(inp, -(-len(inp["edge_src"]) // 4) * 4)
    a, b = _both(inp)
    want = _ref_train_losses(lambda p, bt: (ref_gnn.gnn_loss(p, ref_cfg, bt), {}),
                             ref_params, [a] * 3, kw)
    init_b, step_b = loop.make_train_step(lambda p, bt: (gnn.gnn_loss(p, cfg, bt), {}),
                                          optimizer.AdamWConfig(**kw))
    state = init_b(params)
    got = []
    for _ in range(3):
        state, m = step_b(state, b)
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert state["params"] is params and int(state["opt"]["step"]) == 3


def test_train_view_takes_a_list_of_layer_dicts():
    """The GNNs' ``layers`` is a list of per-layer dicts: each leaf becomes
    a grad-requiring view whose ``.grad`` is the matching gradient buffer."""
    _, _, cfg, params = _params("meshgraphnet")
    grads = tree_map(torch.zeros_like, params)
    view = loop.train_view(params, grads)
    assert isinstance(view["layers"], list) and len(view["layers"]) == cfg.n_layers
    for v, p, g in zip(tree_leaves(view), tree_leaves(params), tree_leaves(grads)):
        assert v.requires_grad and v.data_ptr() == p.data_ptr() and v.grad is g


# --------------------------------------------------------------- launcher --
@pytest.mark.parametrize("arch", ["gin-tu", "meshgraphnet", "graphcast", "equiformer-v2",
                                  "wide-deep"])
def test_launcher_runs_on_cpu(arch, capsys):
    assert train_launch.main(["--arch", arch, "--device", "cpu", "--steps", "3"]) == []
    assert f"[{arch}] done: ok" in capsys.readouterr().out
    hist = train_launch.main(["--arch", arch, "--device", "cpu", "--steps", "5"])
    assert [h[0] for h in hist] == [5] and np.isfinite(hist[0][1])


@pytest.mark.parametrize("arch", ["gin-tu", "equiformer-v2", "wide-deep"])
def test_launcher_batches_equal_the_reference_launchers(arch, monkeypatch):
    """The batches the reference launcher trains on (captured from its
    ``TrainLoop``), array for array, against the port launcher's."""
    from repro.launch import train as ref_launch

    seen = {}

    class Capture:
        def __init__(self, step_fn, data_iter, **kw):
            seen.setdefault("data", []).append(data_iter)

        def run(self, state, n):
            return state, []

    monkeypatch.setattr(ref_launch, "TrainLoop", Capture)
    monkeypatch.setattr(train_launch, "TrainLoop", Capture)
    monkeypatch.setattr("sys.argv", ["train", "--arch", arch, "--steps", "1"])
    ref_launch.main()
    train_launch.main(["--arch", arch, "--device", "cpu", "--steps", "1"])
    ref_it, port_it = seen["data"]
    for _ in range(2):
        want, got = next(ref_it), next(port_it)
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            w = np.asarray(w)
            assert got[key].numpy().dtype == w.dtype and np.array_equal(got[key].numpy(), w), key


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_steps_leave_no_tensor_behind(arch):
    """A step's recomputed graph is freed with its backward: the count of
    live tensors is the same after the second step as after the first
    (nested checkpoints whose functions closed over a tensor of the graph
    kept every layer's recomputation alive: 5.1 GB more each step at
    EquiformerV2's full width on an NVIDIA H100 80GB HBM3 at 700.00 W)."""
    import gc

    _, _, cfg, params = _params(arch)
    b = _both(_pad_to(_graph_inputs(cfg), -(-len(_graph_inputs(cfg)["edge_src"]) // 4) * 4))[1]
    init, step = loop.make_train_step(lambda p, bt: (gnn.gnn_loss(p, cfg, bt), {}),
                                      optimizer.AdamWConfig())
    state = init(params)
    counts = []
    for _ in range(3):
        state, _m = step(state, b)
        del _m
        gc.collect()
        counts.append(sum(1 for o in gc.get_objects() if torch.is_tensor(o)))
    assert counts[1] == counts[2], counts
