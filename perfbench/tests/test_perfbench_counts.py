"""The count functions against counts made by hand."""
from __future__ import annotations

from perfbench.counts import bfs_frontier, topk_sim, transformer
from perfbench.lib import peaks, weights

DENSE = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1, "d_head": 4, "d_ff": 16,
         "vocab": 10, "moe": None}
MOE = dict(DENSE, d_ff=0, moe={"n_experts": 4, "top_k": 2, "d_ff": 6})


def test_dense_token_flops():
    # per layer: wq 8x8, wk 8x4, wv 8x4, wo 8x8, three FFN matrices 8x16; head 8x10
    per_layer = 64 + 32 + 32 + 64 + 3 * 128
    assert transformer.matmul_flops_per_token(DENSE) == 2 * (2 * per_layer + 80)


def test_moe_token_flops():
    # two of four experts (3 matrices 8x6 each) and the 8x4 router
    per_layer = 64 + 32 + 32 + 64 + 2 * 3 * 48 + 32
    assert transformer.matmul_flops_per_token(MOE) == 2 * (2 * per_layer + 80)


def test_attention_flops():
    # QK^T and PV: d_head multiply-adds each, per head, layer and position attended
    assert transformer.attention_flops(DENSE, 5) == 2 * (2 * 2 * 4 * 5) * 2


def test_topk_sim_counts():
    assert topk_sim.flops(2, 3, 4, 1) == 2 * 2 * 3 * 4
    assert topk_sim.bytes_moved(2, 3, 4, 1) == 4 * (2 * 4 + 3 * 4) + 8 * 2


def test_bfs_frontier_counts():
    assert bfs_frontier.bytes_moved(3, 5, 7) == 3 * 5 + 3 * 5 + 4 * 7
    assert bfs_frontier.flops(3, 5, 7) == 21


def test_roofline_takes_the_larger_bound():
    assert peaks.roofline_s(peaks.FP32_FLOPS, 0.0, peaks.FP32_FLOPS) == 1.0
    assert peaks.roofline_s(0.0, peaks.HBM_BYTES_PER_S, peaks.FP32_FLOPS) == 1.0


def test_param_count_matches_the_weights():
    import torch

    for cfg in (dict(DENSE, rope_theta=1e4, norm_eps=1e-5, sliding_window=None),
                dict(MOE, rope_theta=1e4, norm_eps=1e-5, sliding_window=None)):
        p = weights.make_params(cfg, 2**40 + 3, "cpu")
        leaves = []

        def walk(t):
            for v in t.values():
                walk(v) if isinstance(v, dict) else leaves.append(v)

        walk(p)
        assert sum(x.numel() for x in leaves) == weights.n_params(cfg)
        assert torch.equal(weights.make_params(cfg, 2**40 + 3, "cpu")["head"], p["head"])


def test_kernel_names_keep_their_namespace_and_template():
    from perfbench.lib.trace import short_name

    raw = ("void (anonymous namespace)::topk_sim_scan_kernel<1, 0>(float const*, float const*, "
           "(anonymous namespace)::Entry*, int)")
    assert short_name(raw) == "void {anonymous}::topk_sim_scan_kernel<1, 0>"
    lam = ("void at::native::vectorized_elementwise_kernel<4, at::native::(anonymous namespace)::"
           "where_kernel_impl(at::TensorIterator&)::{lambda()#1}, std::array<char*, 2ul> >(int)")
    assert short_name(lam, width=1000).endswith("std::array<char*, 2ul> >")
    assert short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"


def test_roofline_readers_stay_within_the_roofline():
    """A trace whose kernels took exactly their least time reads 100%."""
    import importlib.util

    from conftest import ROOT
    from perfbench.counts import bfs_frontier, topk_sim

    def reader(name):
        spec = importlib.util.spec_from_file_location(name, ROOT / "perfbench" / "metrics" /
                                                      f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    q, n, d, e = 256, 169_343, 128, 1_354_712
    t_topk = peaks.roofline_s(topk_sim.flops(q, n, d, 3), topk_sim.bytes_moved(q, n, d, 3),
                              peaks.FP32_FLOPS)
    t_hop = peaks.roofline_s(bfs_frontier.flops(q, n, e), bfs_frontier.bytes_moved(q, n, e),
                             peaks.FP32_FLOPS)
    trace = {"n_device_events": 9,
             "device_ops": {"void {anonymous}::topk_sim_scan_kernel<1, 0>": 2 * t_topk * 0.75,
                            "void {anonymous}::topk_merge_kernel": 2 * t_topk * 0.25,
                            "frontier_hop_bulk_kernel": 6 * t_hop * 0.9,
                            "pack_frontier_kernel": 6 * t_hop * 0.1},
             "launches": {"void {anonymous}::topk_sim_scan_kernel<1, 0>": 2,
                          "void {anonymous}::topk_merge_kernel": 2, "frontier_hop_bulk_kernel": 6,
                          "pack_frontier_kernel": 6}}
    rec = {"kind": "retrieve", "trace": trace, "batch": q, "n_nodes": n, "dim": d, "k_seeds": 3,
           "arcs": e}
    assert abs(reader("topk_sim_roofline")(rec) - 100.0) < 1e-9
    assert abs(reader("bfs_frontier_roofline")(rec) - 100.0) < 1e-9
