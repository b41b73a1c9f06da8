"""The port's Wide & Deep (``repro_torch.models.recsys``) against the
reference on the CPU, with the reference's weights carried over and the same
seeded numpy inputs: logits, loss and gradients with ``-1`` bag pads,
``retrieval_scores``, the recsys input builder and three train steps.

Tolerances:
- logits and loss ``rtol=1e-5`` plus ``1e-5 * max|ref|`` absolute: fp32 on
  both sides, sums in another order;
- gradients ``rtol=1e-4`` plus ``1e-4 * max|ref|`` of the leaf;
- train-step losses ``rtol=1e-4``;
- retrieval ids exact (the scores' top 100 are clear of each other by far
  more than the two sums' rounding), scores ``atol=1e-5``; ``concretize``
  arrays exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import common as ref_common
from repro.kernels.topk_sim import ops as ref_topk
from repro.models.recsys import wide_deep as ref_wd
from repro.training import loop as ref_loop
from repro.training import optimizer as ref_opt
from repro_torch import configs
from repro_torch.configs import common
from repro_torch.models.recsys import wide_deep as wd
from repro_torch.training import loop, optimizer
from repro_torch.tree import params_from_jax, tree_leaves, tree_map


def _close(got, want, rel):
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * float(np.max(np.abs(want))))


def _models(seed=0, **over):
    ref_cfg = dataclasses.replace(ref_configs.get_config("wide-deep").reduced_cfg, **over)
    cfg = wd.WideDeepConfig(**dataclasses.asdict(ref_cfg))
    ref_params = ref_wd.init_wide_deep(jax.random.PRNGKey(seed), ref_cfg)
    # the reference starts the wide weights at zero; give them values so
    # their gradients reach the deep tower's scale
    ref_params = dict(ref_params, wide=ref_params["table"][:, 0] * 10.0,
                      wide_dense=jnp.linspace(-0.2, 0.3, ref_cfg.n_dense))
    return ref_cfg, ref_params, cfg, params_from_jax(jax.tree.map(np.asarray, ref_params),
                                                     device="cpu")


def _batch(cfg, b, seed, pad_share=0.3):
    """Pre-offset ids with a share of ``-1`` bag pads (whole bags too)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.rows_per_field, (b, cfg.n_sparse, cfg.bag_size))
    ids += np.arange(cfg.n_sparse)[None, :, None] * cfg.rows_per_field
    ids = np.where(rng.random(ids.shape) < pad_share, -1, ids)
    ids[0, 0, :] = -1  # an empty bag
    dense = rng.standard_normal((b, cfg.n_dense)).astype(np.float32)
    labels = rng.integers(0, 2, b).astype(np.float32)
    return dense, ids.astype(np.int32), labels


def test_params_and_init_shapes_match():
    ref_cfg, ref_params, cfg, params = _models()
    mine = wd.init_wide_deep(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = ref_wd.init_wide_deep(jax.random.PRNGKey(0), ref_cfg)
    assert list(mine) == list(ref) and list(mine["mlp"]) == list(ref["mlp"])
    for key in ("table", "wide", "wide_dense", "bias"):
        assert tuple(mine[key].shape) == ref[key].shape
    for key in ref["mlp"]:
        assert tuple(mine["mlp"][key].shape) == ref["mlp"][key].shape
    assert float(mine["table"].std()) == pytest.approx(0.01, rel=0.1)
    assert not mine["wide"].any() and not mine["bias"].any()


@pytest.mark.parametrize("pad_share", [0.0, 0.3, 1.0])
def test_logits_loss_and_grads_match(pad_share):
    ref_cfg, ref_params, cfg, params = _models()
    dense, ids, labels = _batch(cfg, 24, seed=1, pad_share=pad_share)
    a = (jnp.asarray(dense), jnp.asarray(ids), jnp.asarray(labels))
    b = (torch.from_numpy(dense), torch.from_numpy(ids), torch.from_numpy(labels))
    _close(wd.wide_deep_logits(params, cfg, *b[:2]), ref_wd.wide_deep_logits(
        ref_params, ref_cfg, *a[:2]), 1e-5)
    loss_a, g_a = jax.value_and_grad(ref_wd.wide_deep_loss)(ref_params, ref_cfg, *a)
    grads = tree_map(torch.zeros_like, params)
    loss_b = wd.wide_deep_loss(loop.train_view(params, grads), cfg, *b)
    loss_b.backward()
    _close(loss_b, loss_a, 1e-5)
    flat_a = jax.tree.leaves(jax.tree.map(np.asarray, g_a))
    assert len(flat_a) == len(tree_leaves(grads))
    for ga, gb in zip(flat_a, tree_leaves(grads)):
        _close(gb, ga, 1e-4)
    # pads reach no row: rows no valid id names get no gradient
    named = np.zeros(cfg.total_rows, bool)
    named[ids[ids >= 0]] = True
    assert not grads["table"][torch.from_numpy(~named)].any()
    assert not grads["wide"][torch.from_numpy(~named)].any()


def test_embedding_bag_sums_valid_slots_in_order():
    table = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    ids = torch.tensor([[[1, -1, 3], [-1, -1, -1]]], dtype=torch.int32)
    out = wd.embedding_bag(table, ids)
    np.testing.assert_array_equal(out.numpy(), [[[2 + 6, 3 + 7], [0, 0]]])
    np.testing.assert_array_equal(out.numpy(), ref_wd.embedding_bag(
        jnp.asarray(table.numpy()), jnp.asarray(ids.numpy())))


@pytest.mark.parametrize("q,n,k", [(1, 3000, 100), (3, 2500, 7), (1, 50, 100)])
def test_retrieval_scores_ids_equal_the_reference(q, n, k):
    """The reference's ``topk_similarity`` (its Pallas kernel in interpret
    mode from N = 2048) against the port's (its plain version on the CPU)."""
    rng = np.random.default_rng(n)
    cand = rng.standard_normal((n, 32)).astype(np.float32)
    query = rng.standard_normal((q, 32) if q > 1 else (32,)).astype(np.float32)
    s_a, i_a = ref_wd.retrieval_scores(jnp.asarray(query), jnp.asarray(cand), k)
    s_b, i_b = wd.retrieval_scores(torch.from_numpy(query), torch.from_numpy(cand), k)
    assert i_b.dtype == torch.int32 and tuple(i_b.shape) == (q, min(k, n))
    np.testing.assert_array_equal(i_b.numpy(), np.asarray(i_a))
    np.testing.assert_allclose(s_b.numpy(), np.asarray(s_a), atol=1e-5, rtol=0)
    s_r, i_r = ref_topk.topk_similarity(jnp.asarray(query.reshape(q, -1)), jnp.asarray(cand), k,
                                        use_kernel=False)
    np.testing.assert_array_equal(i_b.numpy(), np.asarray(i_r))


@pytest.mark.parametrize("name,kind,params", [("train_batch", "train", dict(batch=16)),
                                              ("serve_p99", "infer", dict(batch=5)),
                                              ("retrieval_cand", "retrieval",
                                               dict(batch=1, n_candidates=300, k=10))])
def test_concretize_recsys_arrays_equal(name, kind, params):
    ref_cfg = ref_configs.get_config("wide-deep").reduced_cfg
    cfg = wd.WideDeepConfig(**dataclasses.asdict(ref_cfg))
    want = ref_common.recsys_inputs(ref_common.ShapeSpec(name, kind, params), ref_cfg,
                                    abstract=False)
    got = common.recsys_inputs(common.ShapeSpec(name, kind, params), cfg, abstract=False,
                               device="cpu")
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w)
        assert got[key].numpy().dtype == w.dtype and np.array_equal(got[key].numpy(), w), key


def test_input_specs_builds_the_registry_cell():
    got = configs.input_specs("wide-deep", "serve_p99", abstract=False, device="cpu")
    want = ref_configs.input_specs("wide-deep", "serve_p99", abstract=False)
    for key, w in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(w)), key


def test_train_steps_match():
    ref_cfg, ref_params, cfg, params = _models()
    kw = dict(lr=1e-3, warmup_steps=5, total_steps=3)
    init_a, step_a = ref_loop.make_train_step(
        lambda p, bt: (ref_wd.wide_deep_loss(p, ref_cfg, *bt), {}), ref_opt.AdamWConfig(**kw))
    init_b, step_b = loop.make_train_step(
        lambda p, bt: (wd.wide_deep_loss(p, cfg, bt["dense"], bt["sparse_ids"], bt["labels"]),
                       {}), optimizer.AdamWConfig(**kw))
    state_a, step_a = init_a(ref_params), jax.jit(step_a)
    state_b = init_b(params)
    for i in range(3):
        dense, ids, labels = _batch(cfg, 32, seed=10 + i)
        state_a, m_a = step_a(state_a, (jnp.asarray(dense), jnp.asarray(ids),
                                        jnp.asarray(labels)))
        state_b, m_b = step_b(state_b, {"dense": torch.from_numpy(dense),
                                        "sparse_ids": torch.from_numpy(ids),
                                        "labels": torch.from_numpy(labels)})
        np.testing.assert_allclose(float(m_b["loss"]), float(m_a["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(m_b["grad_norm"]), float(m_a["grad_norm"]), rtol=1e-4)
    for pa, pb in zip(jax.tree.leaves(state_a["params"]), tree_leaves(state_b["params"])):
        _close(pb, pa, 1e-4)
