"""Port training vs the reference on the CPU with the same weights and data
(numpy, seeded): ``lm_loss`` and its gradients (chunked and dense
attention), ``adamw_update``, the schedule, ``compress``, the fault
monitors, three steps of ``make_train_step`` and the launcher.

Tolerances:
- loss and gradients ``atol=rtol=1e-4``: fp32 on both sides, sums in
  another order (XLA vs ATen), compounded over two layers and the backward;
- ``adamw_update`` with fp32 state ``rtol=1e-6, atol=1e-7``: elementwise
  fp32 arithmetic in the same order, only the global norm (a sum) differs in
  its last bits; bf16 state or parameters within one bf16 ulp (``rtol``
  2^-8), since a last-bit difference in the fp32 value can round the stored
  bf16 the other way;
- train-step losses ``rtol=1e-3``: Adam divides by sqrt(v) + eps, so where a
  gradient entry is near zero (|g| ~ eps) a last-bit difference in it can
  flip the sign of that entry's update; the loss moves far less than that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as ref_comp
from repro.distributed import fault as ref_fault
from repro.models.transformer import TransformerConfig as RefConfig
from repro.models.transformer import model as ref_tm
from repro.training import loop as ref_loop
from repro.training import optimizer as ref_opt
from repro_torch.distributed import compression, fault
from repro_torch.launch import train as train_launch
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer.config import TransformerConfig
from repro_torch.training import loop, optimizer
from repro_torch.tree import tree_leaves, tree_map

TOL = dict(atol=1e-4, rtol=1e-4)
BASE = dict(name="t", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
            vocab=97, dtype="float32", sliding_window=48)


def _models(**kw):
    kw = dict(BASE, **kw)
    ref_cfg, cfg = RefConfig(**kw), TransformerConfig(**kw)
    ref_params = ref_tm.init_params(jax.random.PRNGKey(0), ref_cfg)
    params = tm.params_from_jax(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return ref_cfg, ref_params, cfg, params


def _batch(seed, b, s, vocab):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = rng.random((b, s)) < 0.8
    return toks, mask


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy() if isinstance(got, torch.Tensor)
                               else got, np.asarray(want, np.float32), **(tol or TOL))


# ------------------------------------------------------------- lm_loss ----
@pytest.mark.parametrize("seq,chunk", [(512, 128), (64, 512)])  # chunked, dense
def test_lm_loss_and_grads_match(seq, chunk):
    ref_cfg, ref_params, cfg, params = _models(q_chunk=chunk, kv_chunk=chunk, loss_chunk=200)
    toks, mask = _batch(seq, 2, seq, 97)
    (loss_a, met_a), g_a = jax.value_and_grad(ref_tm.lm_loss, has_aux=True)(
        ref_params, jnp.asarray(toks), jnp.asarray(mask), ref_cfg)
    grads = tree_map(torch.zeros_like, params)
    loss_b, met_b = tm.lm_loss(loop.train_view(params, grads), torch.from_numpy(toks),
                               torch.from_numpy(mask), cfg)
    loss_b.backward()
    _close(loss_b, loss_a)
    for key in ("nll", "aux", "tokens"):
        _close(met_b[key], met_a[key])
    flat_a = jax.tree.map(np.asarray, g_a)
    for name in ("embed", "ln_f", "head"):
        _close(grads[name], flat_a[name])
    for name, g in grads["layers"].items():
        _close(g, flat_a["layers"][name])


def test_per_layer_leaves_give_the_stacked_gradients():
    _, _, cfg, params = _models()
    toks, mask = (torch.from_numpy(x) for x in _batch(1, 2, 40, 97))
    grads = tree_map(torch.zeros_like, params)
    tm.lm_loss(loop.train_view(params, grads), toks, mask, cfg)[0].backward()
    stacked = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    tm.lm_loss(stacked, toks, mask, dataclasses.replace(cfg, remat=False))[0].backward()
    for g, p in zip(tree_leaves(grads), tree_leaves(stacked)):
        np.testing.assert_allclose(g.numpy(), p.grad.numpy(), rtol=1e-6, atol=1e-7)


def test_lm_logits_match():
    ref_cfg, ref_params, cfg, params = _models()
    toks, _ = _batch(2, 2, 24, 97)
    _close(tm.lm_logits(params, torch.from_numpy(toks), cfg),
           ref_tm.lm_logits(ref_params, jnp.asarray(toks), ref_cfg))


# ----------------------------------------------------------- optimizer ----
def _opt_tree(seed, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"embed": (9, 5), "layers": {"w": (3, 6, 4), "ln": (3, 6)}, "bias": (7,)}
    return jax.tree.map(lambda s: rng.standard_normal(s).astype(dtype), shapes,
                        is_leaf=lambda x: isinstance(x, tuple))


def _to_torch(tree, dtype):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x, np.float32)).to(dtype), tree)


@pytest.mark.parametrize("param_dtype,state_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "float32")])
@pytest.mark.parametrize("clip", [None, 0.5])
@pytest.mark.parametrize("piece", [optimizer.PIECE, 8])  # 8: every leaf in slices
def test_adamw_update_matches(param_dtype, state_dtype, clip, piece, monkeypatch):
    monkeypatch.setattr(optimizer, "PIECE", piece)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, grad_clip=clip, state_dtype=state_dtype)
    cfg_a, cfg_b = ref_opt.AdamWConfig(**kw), optimizer.AdamWConfig(**kw)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[param_dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[param_dtype]
    p_a = jax.tree.map(lambda x: jnp.asarray(x, jdt), _opt_tree(0, np.float32))
    p_b = _to_torch(jax.tree.map(np.asarray, p_a), tdt)
    s_a, s_b = ref_opt.adamw_init(p_a, cfg_a), optimizer.adamw_init(p_b, cfg_b)
    bf16 = "bfloat16" in (param_dtype, state_dtype)
    tol = dict(rtol=2**-8, atol=1e-6) if bf16 else dict(rtol=1e-6, atol=1e-7)
    for step in range(3):
        g_np = _opt_tree(10 + step, np.float32)
        g_a = jax.tree.map(lambda x: jnp.asarray(x, jdt), g_np)
        g_b = _to_torch(jax.tree.map(np.asarray, g_a), tdt)
        p_a, s_a, m_a = ref_opt.adamw_update(g_a, s_a, p_a, cfg_a)
        p_b, s_b, m_b = optimizer.adamw_update(g_b, s_b, p_b, cfg_b)
        _close(m_b["lr"], m_a["lr"], rtol=1e-6)
        _close(m_b["grad_norm"], m_a["grad_norm"], rtol=1e-6)
        assert int(s_b["step"]) == int(s_a["step"]) == step + 1
        for got, want in zip(tree_leaves(p_b) + tree_leaves(s_b["m"]) + tree_leaves(s_b["v"]),
                             jax.tree.leaves(p_a) + jax.tree.leaves(s_a["m"])
                             + jax.tree.leaves(s_a["v"])):
            assert got.dtype == {jnp.dtype(jnp.float32): torch.float32,
                                 jnp.dtype(jnp.bfloat16): torch.bfloat16}[want.dtype]
            _close(got, want, **tol)


def test_weight_decay_only_on_matrices():
    cfg = optimizer.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.5, grad_clip=None)
    params = {"vec": torch.ones(4), "mat": torch.ones(2, 2)}
    zero = {"vec": torch.zeros(4), "mat": torch.zeros(2, 2)}
    optimizer.adamw_update(zero, optimizer.adamw_init(params, cfg), params, cfg)
    assert torch.equal(params["vec"], torch.ones(4))  # zero grad, no decay: unchanged
    assert torch.all(params["mat"] < 1)


@pytest.mark.parametrize("warmup,total", [(100, 10_000), (0, 50), (5, 5)])
def test_schedule_matches(warmup, total):
    kw = dict(lr=3e-4, warmup_steps=warmup, total_steps=total, min_lr_frac=0.1)
    steps = np.array([0, 1, 3, 5, 50, 99, 100, 101, 5000, 10_000, 20_000], np.float32)
    want = [ref_opt._schedule(ref_opt.AdamWConfig(**kw), jnp.float32(s)) for s in steps]
    got = [optimizer._schedule(optimizer.AdamWConfig(**kw), torch.tensor(s)) for s in steps]
    np.testing.assert_allclose([float(g) for g in got], np.asarray(want), rtol=1e-6, atol=1e-12)


# --------------------------------------------------------- compression ----
@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compress_matches_with_error_feedback(kind):
    cfg_a = ref_comp.CompressionConfig(kind=kind, topk_frac=0.1)
    cfg_b = compression.CompressionConfig(kind=kind, topk_frac=0.1)
    g0 = _opt_tree(3, np.float32)
    r_a, r_b = ref_comp.init_residuals(g0), compression.init_residuals(_to_torch(g0, torch.float32))
    for rnd in range(3):
        g = _opt_tree(20 + rnd, np.float32)
        c_a, r_a = ref_comp.compress(jax.tree.map(jnp.asarray, g), r_a, cfg_a)
        c_b, r_b = compression.compress(_to_torch(g, torch.float32), r_b, cfg_b)
        for got, want in zip(tree_leaves(c_b) + tree_leaves(r_b),
                             jax.tree.leaves(c_a) + jax.tree.leaves(r_a)):
            _close(got, want, rtol=1e-6, atol=1e-6)
    g = _to_torch(g0, torch.float32)
    assert compression.compress(g, r_b, compression.CompressionConfig())[0] is g


# --------------------------------------------------------------- fault ----
def test_straggler_monitor_and_heartbeat_match():
    events = [(0, 1.0), (1, 1.1), (2, 3.5), (0, 1.2), (1, 0.9), (2, 4.0), (3, 1.0)] * 4
    mons = [ref_fault.StragglerMonitor(threshold=2.0, window=5),
            fault.StragglerMonitor(threshold=2.0, window=5)]
    assert mons[0].median_time() is mons[1].median_time() is None
    assert mons[0].stragglers() == mons[1].stragglers() == []
    beats = [ref_fault.Heartbeat(max_missed=2, interval_s=1.0),
             fault.Heartbeat(max_missed=2, interval_s=1.0)]
    for t, (host, dt) in enumerate(events):
        for m in mons:
            m.record(host, dt)
        for hb in beats:
            hb.beat(host, now=float(t))
        assert mons[0].median_time() == mons[1].median_time()
        assert mons[0].stragglers() == mons[1].stragglers()
        assert beats[0].dead_hosts(now=t + 2.5) == beats[1].dead_hosts(now=t + 2.5)
    assert mons[1].stragglers() == [2]


# ----------------------------------------------------------- train step ----
@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("kind", ["none", "int8"])
def test_train_step_losses_match(n_micro, kind):
    ref_cfg, ref_params, cfg, params = _models()
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    loss_a = lambda p, b: ref_tm.lm_loss(p, b["tokens"], b["loss_mask"], ref_cfg)  # noqa: E731
    loss_b = lambda p, b: tm.lm_loss(p, b["tokens"], b["loss_mask"], cfg)  # noqa: E731
    init_a, step_a = ref_loop.make_train_step(
        loss_a, ref_opt.AdamWConfig(**kw), ref_comp.CompressionConfig(kind=kind), n_micro)
    init_b, step_b = loop.make_train_step(
        loss_b, optimizer.AdamWConfig(**kw), compression.CompressionConfig(kind=kind), n_micro)
    state_a, state_b = init_a(ref_params), init_b(params)
    step_a = jax.jit(step_a)
    for i in range(3):
        toks, mask = _batch(100 + i, 4, 48, 97)
        state_a, m_a = step_a(state_a, {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)})
        state_b, m_b = step_b(state_b, {"tokens": torch.from_numpy(toks),
                                        "loss_mask": torch.from_numpy(mask)})
        for key in ("loss", "nll", "tokens", "grad_norm", "lr"):
            _close(m_b[key], m_a[key], rtol=1e-3, atol=0)
    assert state_b["params"] is params  # updated in place
    assert int(state_b["opt"]["step"]) == 3


def test_train_loop_logs_and_checkpoints():
    _, _, cfg, params = _models()
    init, step = loop.make_train_step(
        lambda p, b: tm.lm_loss(p, b["tokens"], b["loss_mask"], cfg), optimizer.AdamWConfig())
    saved, logs = [], []

    class Saver:
        def save(self, step, state):
            saved.append(step)

    data = train_launch._lm_data(cfg, 2, 16, device="cpu")
    lp = loop.TrainLoop(step_fn=step, data_iter=data, checkpointer=Saver(), checkpoint_every=2,
                        log_every=3, log_fn=logs.append)
    _, history = lp.run(init(params), 6)
    assert [h[0] for h in history] == [3, 6] and len(logs) == 2
    assert saved == [2, 4, 6]
    assert all(np.isfinite(h[1]) for h in history)
    assert lp.monitor.median_time() > 0 and lp.heartbeat.dead_hosts() == []


def test_train_launcher_runs_on_cpu(capsys):
    history = train_launch.main(["--arch", "starcoder2-3b", "--device", "cpu", "--steps", "10",
                                 "--batch", "2", "--seq", "32"])
    assert [h[0] for h in history] == [5, 10]
    assert all(np.isfinite(h[1]) and 3.0 < h[1] < 6.0 for h in history)  # ~log(128) = 4.85
    assert "done: loss" in capsys.readouterr().out
