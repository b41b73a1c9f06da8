"""Hand-written kernels against their plain versions on the card, at edge
shapes the main path does not reach (query groups, odd widths, tiny N,
ragged candidate rows, worksets of one id or of more than 48 KB; flash
attention over head dims, GQA ratios, windows, both dtypes and ragged S;
ELL aggregation over odd widths and sentinel ids; the IVF scan over ragged,
narrow and tied candidate sets; both scan kernels' variants, merges and
workspace), the index kinds and an IVF serve on the card against the CPU,
the paged arena, int8 KV and speculative decode on the card against the
CPU and against one-token decode.  Needs an NVIDIA Hopper GPU and nvcc; skips elsewhere.

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Scores within ``atol=1e-5`` (fp32 dot products of unit vectors, summed in
another order); ids, BFS reach, workset marks and retrieved subgraphs exact.
Flash attention: fp32 within ``atol=rtol=1e-4`` (the same products summed
in another order over up to S keys); bf16 within one bf16 ulp
(``rtol=2**-7``) plus ``2**-7 * max|ref|`` absolute, since p is rounded to
bf16 before P·V and a last-bit difference in an fp32 score can round it the
other way, and every output is rounded to bf16 once.  ``ell_spmm`` and
``ivf_scan`` bit for bit: their plain versions add in the kernels' order.
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _unit(rng, shape, dev):
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    return x / x.norm(dim=-1, keepdim=True)


@pytest.mark.parametrize("q,n,d,k", [(1, 1, 8, 1), (3, 255, 40, 7), (9, 3000, 128, 3),
                                     (20, 5000, 96, 64), (4, 700, 1024, 300),
                                     (5, 1000, 128, 32), (64, 20_000, 128, 32), (1, 1000, 128, 256),
                                     (2, 1000, 128, 300), (65, 3000, 64, 5), (9, 2000, 1030, 3),
                                     (3, 40, 16, 40), (1, 169, 128, 169)])
def test_topk_sim_kernel_matches_plain(dev, q, n, d, k):
    """Query groups (Q = 9, 64, 65), N = 1 and N under one block's range,
    k at and past the 256-entry lists (the tree merge), k = N, rows of two
    column chunks (D = 1030, the plain variant): one launch, the plan the
    wrapper computed."""
    from repro_torch.kernels.topk_sim import kernel, ops

    rng = np.random.default_rng(n)
    qv, ev = _unit(rng, (q, d), dev), _unit(rng, (n, d), dev)
    before = kernel.launches.count
    s_k, i_k = ops.topk_similarity(qv, ev, k)
    torch.cuda.synchronize()
    assert kernel.launches.count == before + 1
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert kernel.last_plan == kernel.launch_plan(q, n, d, k, ev.data_ptr(), sm)
    s_p, i_p = ops.topk_similarity(qv, ev, k, use_kernel=False)
    assert (s_k - s_p).abs().max().item() <= 1e-5
    assert torch.equal(i_k, i_p)


@pytest.mark.parametrize("case", ["odd_width_view", "unaligned", "block_boundaries"])
def test_topk_sim_variants_and_block_boundaries(dev, case):
    """An emb[:, :3] view and a table 4 bytes off 16-byte alignment take the
    plain-load variant; copies of one row on both sides of every block
    boundary and in the last block come out lowest id first."""
    from repro_torch.kernels.topk_sim import kernel, ops

    rng = np.random.default_rng(len(case))
    n = 20_000
    ev = _unit(rng, (n, 128), dev)
    qv = _unit(rng, (5, 128), dev)
    variant = kernel.PLAIN
    if case == "odd_width_view":
        ev, qv = ev[:, :3], qv[:, :3]
    elif case == "unaligned":
        flat = torch.zeros(n * 128 + 4, device=dev)
        ev = flat[1:1 + n * 128].view(n, 128).copy_(ev)
    else:
        variant = kernel.BULK
        sm = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = kernel.launch_plan(5, n, 128, 8, ev.data_ptr(), sm)
        tiles = -(-n // 64)
        cuts = [x * tiles // plan.grid_x * 64 for x in range(1, plan.grid_x)]
        dup = sorted({0, n - 1, *cuts[:4], *[c - 1 for c in cuts[:4]]})
        ev[dup] = ev[dup[0]].clone()
        qv[0] = ev[dup[0]]
    s, i = ops.topk_similarity(qv, ev, 8)
    torch.cuda.synchronize()
    assert kernel.last_plan.variant == variant
    s_p, i_p = ops.topk_similarity(qv, ev, 8, use_kernel=False)
    assert (s - s_p).abs().max().item() <= 1e-5 and torch.equal(i, i_p)
    if case == "block_boundaries":
        assert i[0].tolist() == dup[:8]


@pytest.mark.parametrize("op", ["topk_sim", "ivf_scan"])
def test_scan_kernels_reset_their_workspace(dev, op):
    """Two calls in a row, and calls on two streams one after the other,
    give identical results (and a call at another Q between them changes
    nothing); ivf_scan's tickets are left zero."""
    from repro_torch.kernels import topk_merge
    from repro_torch.kernels.ivf_scan import ops as iops
    from repro_torch.kernels.topk_sim import ops as tops

    rng = np.random.default_rng(5)
    ev = _unit(rng, (30_000, 128), dev)
    qv = _unit(rng, (6, 128), dev)
    cand = torch.from_numpy(rng.integers(0, 30_001, (6, 5000)).astype(np.int32)).to(dev)
    cmask = cand < 30_000

    def call(q=qv):
        if op == "topk_sim":
            return tops.topk_similarity(q, ev, 10)
        return iops.ivf_candidate_scan(q, ev, cand[:q.shape[0]], cmask[:q.shape[0]], 10)

    first = call()
    second = call()
    call(qv[:2])
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        third = call()
    torch.cuda.current_stream(dev).wait_stream(side)
    fourth = call()
    torch.cuda.synchronize()
    for other in (second, third, fourth):
        assert torch.equal(first[0], other[0]) and torch.equal(first[1], other[1])
    for ws in topk_merge._workspaces.values():
        assert not ws.any()


def test_topk_sim_ties_lowest_id_first(dev):
    from repro_torch.kernels.topk_sim import ops

    rng = np.random.default_rng(0)
    ev = _unit(rng, (2000, 64), dev)
    ev[[10, 300, 1999]] = ev[7].clone()
    s, i = ops.topk_similarity(ev[7:8].clone(), ev, 5)
    assert i[0, :4].tolist() == [7, 10, 300, 1999]
    zeros = torch.zeros((2, 64), device=dev)  # padded serving rows: all scores tie
    assert ops.topk_similarity(zeros, ev, 3)[1].tolist() == [[0, 1, 2], [0, 1, 2]]


@pytest.mark.parametrize("q,n,k,p", [(1, 1, 8, 0.5), (3, 1000, 13, 0.05), (40, 2000, 16, 0.01),
                                     (5, 4097, 24, 0.0), (2, 3000, 8, 1.0)])
def test_bfs_frontier_kernel_matches_plain(dev, q, n, k, p):
    from repro_torch.kernels.bfs_frontier import kernel, ops

    rng = np.random.default_rng(q * n)
    nbr = torch.from_numpy(rng.integers(0, n + 1, (n, k)).astype(np.int32)).to(dev)
    msk = torch.from_numpy(rng.random((n, k)) < 0.6).to(dev)
    fr = torch.from_numpy(rng.random((q, n)) < p).to(dev)
    before = kernel.launches.count
    got = ops.frontier_hop(fr, nbr, msk)
    torch.cuda.synchronize()
    assert kernel.launches.count == before + 1
    assert torch.equal(got, ops.frontier_hop(fr, nbr, msk, use_kernel=False))


def _offset_view(x, offset):
    """A contiguous copy of ``x`` that starts ``offset`` elements into its
    allocation (an unaligned view)."""
    flat = torch.zeros(x.numel() + 16, dtype=x.dtype, device=x.device)
    view = flat[offset:offset + x.numel()].view(x.shape)
    view.copy_(x)
    return view


@pytest.mark.parametrize("case", ["citation_hub", "q33", "q64", "tail8", "offset8", "offset1",
                                  "nbr_offset4", "random_sentinels", "full_lists", "wide_rows"])
def test_bfs_frontier_variants_match_plain(dev, case):
    """Each variant of the hop at its edges: a prefix-mask citation ELL with
    a hub row (bulk), two query groups (Q = 33, 64), a last tile 8 bytes
    past 16 (K = 24, N odd), mask views 8 and 1 bytes off 16-byte alignment
    (rows, 8 and 1 slots a lane), ids 4 bytes off it (rows, 8 slots a
    lane), random non-prefix masks with live sentinel slots, 2400-slot rows
    (16-row tiles of 2-row slices), and rows too wide for the ring (rows
    variant)."""
    from repro_torch.graph import generators
    from repro_torch.graph.ell import csr_to_ell
    from repro_torch.kernels.bfs_frontier import kernel, ops

    rng = np.random.default_rng(len(case))
    q, offset = {"q33": 33, "q64": 64}.get(case, 4), {"offset8": 8, "offset1": 1}.get(case, 0)
    if case in ("citation_hub", "q33", "q64", "offset8", "offset1", "nbr_offset4"):
        ell = csr_to_ell(generators.citation_graph(20_000, avg_deg=8, seed=1), device="cuda")
        nbr, msk = ell.nbr, ell.nbr_mask
        deg = msk.sum(1)
        assert deg.max().item() >= 20 * deg.float().mean().item()  # a hub row
    else:
        n, k, p = {"tail8": (3001, 24, 0.3), "random_sentinels": (5000, 64, 0.05),
                   "full_lists": (300, 2400, 0.3), "wide_rows": (40, 120_000, 0.001)}[case]
        nbr = torch.from_numpy(rng.integers(0, n + 1, (n, k)).astype(np.int32)).to(dev)
        msk = torch.from_numpy(rng.random((n, k)) < p).to(dev)
        nbr[::3, 0] = n
        msk[::3, 0] = True
    msk = _offset_view(msk, offset) if offset else msk
    nbr = _offset_view(nbr, 1) if case == "nbr_offset4" else nbr  # 4 bytes off
    n, k = nbr.shape
    fr = torch.from_numpy(rng.random((q, n)) < 0.01).to(dev)
    fr[-1] = True
    plan = kernel.launch_plan(q, n, k, msk.data_ptr(), nbr.data_ptr(),
                              torch.cuda.get_device_properties(dev).multi_processor_count)
    want_variant = {"offset8": kernel.ROWS8, "offset1": kernel.ROWS, "nbr_offset4": kernel.ROWS8,
                    "wide_rows": kernel.ROWS8}
    assert plan.variant == want_variant.get(case, kernel.BULK), plan
    before = kernel.launches.count
    got = ops.frontier_hop(fr, nbr, msk)
    torch.cuda.synchronize()
    assert kernel.launches.count == before + 1 and kernel.last_plan == plan
    assert torch.equal(got, ops.frontier_hop(fr, nbr, msk, use_kernel=False))


def test_kernels_refuse_bad_inputs(dev):
    from repro_torch.kernels.bfs_frontier import ops as bops
    from repro_torch.kernels.topk_sim import ops as tops

    ev = torch.zeros((10, 4), device=dev)
    with pytest.raises(ValueError, match="width"):
        tops.topk_similarity(torch.zeros((1, 4), device=dev), ev[:, :3].contiguous(), 2)
    with pytest.raises(ValueError, match="int32"):
        bops.frontier_hop(torch.zeros((1, 10), dtype=torch.bool, device=dev),
                          torch.zeros((10, 8), dtype=torch.int64, device=dev),
                          torch.zeros((10, 8), dtype=torch.bool, device=dev))


def _sorted_rows(rng, q, c, n, dev):
    """Ascending int32 rows with repeats and sentinel-n padding."""
    ws = np.full((q, c), n, np.int32)
    for qi in range(q):
        fill = int(rng.integers(1, c + 1))
        ws[qi, :fill] = np.sort(rng.integers(0, n, fill))
    return torch.from_numpy(ws).to(dev)


@pytest.mark.parametrize("q,c,w", [(1, 1, 1), (3, 7, 1001), (4, 2048, 40_000), (2, 300, 4096),
                                   (5, 20_000, 9_999), (1, 58_112, 4100)])
def test_frontier_expand_kernel_matches_plain(dev, q, c, w):
    """Rows of one id, C not a power of two, rows past 48 KB of shared
    memory, ragged W; candidates equal to the sentinel and int32 max."""
    from repro_torch.kernels.frontier_expand import kernel, ops

    rng = np.random.default_rng(c + w)
    n = max(2 * c, 50)
    ws = _sorted_rows(rng, q, c, n, dev)
    cand = torch.from_numpy(rng.integers(0, n + 1, (q, w)).astype(np.int32)).to(dev)
    cand[:, : min(w, 3)] = n
    cand[:, -1] = torch.iinfo(torch.int32).max
    before = kernel.launches.count
    got = ops.ws_member(ws, cand)
    torch.cuda.synchronize()
    assert kernel.launches.count == before + 1
    assert torch.equal(got, ops.ws_member(ws, cand, use_kernel=False))
    # a candidate row that starts off 16-byte alignment takes the scalar loads
    off = cand[:, 1:]
    assert torch.equal(ops.ws_member(ws, off), ops.ws_member(ws, off, use_kernel=False))


@pytest.mark.parametrize("c", [256, 13_000])
def test_frontier_expand_on_hop_candidates(dev, c):
    """Real hop candidates (prefix masks: live neighbours, then sentinel
    runs), as they are and with one lane inside a sentinel run changed to an
    id of the workset and to one outside it; C = 13,000 puts the row past
    48 KB of shared memory."""
    from repro_torch.core.workset import build_workset
    from repro_torch.graph import generators
    from repro_torch.graph.ell import csr_to_ell
    from repro_torch.kernels.frontier_expand import ops

    n = 60_000
    ell = csr_to_ell(generators.citation_graph(n, avg_deg=8, seed=2), device="cuda")
    seeds = torch.from_numpy(np.random.default_rng(c).choice(n, (3, 3)).astype(np.int32)).to(dev)
    ws = build_workset(ell.nbr, ell.nbr_mask, seeds, max_hops=2, cap=c, use_kernel=False)
    cand = ops.hop_candidates(ws.ids, ell.nbr, ell.nbr_mask)
    assert (cand == n).float().mean().item() > 0.9
    assert torch.equal(ops.ws_member(ws.ids, cand), ops.ws_member(ws.ids, cand, use_kernel=False))
    at = cand.shape[1] // 2 + 17
    for new in (int(ws.ids[0, 0]), n - 1):
        c2 = cand.clone()
        c2[:, at - 40:at + 40] = n  # a sentinel run ...
        c2[0, at] = new  # ... with one lane changed
        got = ops.ws_member(ws.ids, c2)
        assert torch.equal(got, ops.ws_member(ws.ids, c2, use_kernel=False))
        assert bool(got[0, at]) == bool((ws.ids[0] == new).any())


def test_frontier_expand_refuses_rows_past_shared_memory(dev):
    from repro_torch.kernels.frontier_expand import kernel, ops

    ws = torch.zeros((1, 58_113), dtype=torch.int32, device=dev)
    before = kernel.launches.count
    with pytest.raises(ValueError, match="shared memory"):
        ops.ws_member(ws, torch.zeros((1, 8), dtype=torch.int32, device=dev))
    assert kernel.launches.count == before


def test_expand_hop_mark_arm_matches_sort_arm_on_the_card(dev):
    from repro_torch.kernels.frontier_expand import ops

    rng = np.random.default_rng(4)
    n, k, q, c = 5000, 24, 3, 256
    nbr = torch.from_numpy(rng.integers(0, n + 1, (n, k)).astype(np.int32)).to(dev)
    msk = torch.from_numpy(rng.random((n, k)) < 0.5).to(dev)
    ws = np.full((q, c), n, np.int32)
    for qi in range(q):
        fill = int(rng.integers(1, c))
        ws[qi, :fill] = np.sort(rng.choice(n, fill, replace=False))
    dist = np.where(ws < n, rng.integers(0, 2, (q, c)), ops.INF).astype(np.int32)
    args = (torch.from_numpy(ws).to(dev), torch.from_numpy(dist).to(dev), nbr, msk, 2)
    mark = ops.expand_hop(*args, band=5)
    plain = ops.expand_hop(*args, band=5, use_kernel=False)
    for a, b in zip(mark, plain):
        assert torch.equal(a, b)


def test_compact_retrieval_on_the_card_matches_the_cpu(dev):
    """Every strategy through the compact backend (frontier_expand on the
    card), with and without overflow, equals the CPU's plain versions."""
    from repro_torch.core import graph_retrieval as gr
    from repro_torch.graph import generators
    from repro_torch.graph.ell import csr_to_ell

    g = generators.citation_graph(5000, seed=2, with_text=False)
    seeds = np.random.default_rng(3).integers(0, 5000, (4, 3)).astype(np.int32)
    for strategy in ("bfs", "dense", "steiner", "ppr"):
        for cap in (64, 2048):
            out = []
            for d in (dev, torch.device("cpu")):
                sub = gr.retrieve_subgraph(csr_to_ell(g, device=d), seeds, strategy,
                                           mode="compact", workset_cap=cap, max_hops=2,
                                           max_nodes=16)
                out.append([t.cpu() for t in (sub.nodes, sub.mask, sub.dist, sub.overflow)])
            for a, b in zip(*out):
                assert torch.equal(a, b), (strategy, cap)


def test_retrieval_on_the_card_matches_the_cpu(dev):
    """Batched retrieval through both kernels on the card equals the plain
    versions on the CPU, on the same graph and queries."""
    from repro_torch.core.indexing import BruteIndex
    from repro_torch.core.pipeline import PipelineConfig, RGLPipeline
    from repro_torch.graph import generators
    from repro_torch.graph.ell import csr_to_ell

    g = generators.citation_graph(5000, seed=2)
    cfg = PipelineConfig(k_seeds=3, max_nodes=16, filter_budget=6, retrieval_mode="dense")
    out = []
    for d in (dev, torch.device("cpu")):
        ell = csr_to_ell(g, device=d)
        pipe = RGLPipeline(graph=ell, index=BruteIndex.build(g.node_feat, device=d),
                           node_emb=ell.node_feat, config=cfg, device=d)
        res = pipe.retrieve_many(g.node_feat[:5], batch_size=8)
        out.append([t.cpu() for t in (res.seeds, res.nodes, res.mask, res.dist)])
    for a, b in zip(*out):
        assert torch.equal(a, b)


def _flash_close(got, want, what):
    """fp32: ``atol`` and ``rtol`` 1e-4 (the same fp32 arithmetic summed in
    another order).  bf16, element by element: ``rtol`` 2^-7, one bf16 ulp,
    since both sides round an fp32 result once, plus an ``atol`` scaled to
    the element's own row (the last axis), not to the whole tensor, whose
    first rows are many times the typical one.  o's row share is 2^-7: p is
    rounded to bf16 before P·V, and a last-bit difference in an fp32 score
    can round one p the other way, moving o by at most 2^-8·(p/l)·|v|, under
    2^-7 of the row's largest element once a row has two keys.  dq, dk and
    dv keep p and ds in fp32, so their row share is 2^-10.  A floor of 1e-5
    of the largest element covers rows that cancel to zero (dq's first).  At
    the 4096-token training shape the H100's tensor-core kernels used at
    most 0.50 (o), 0.86 (dq), 0.85 (dk) and 0.83 (dv) of it, in
    ``chip_smoke.py``'s ``flash_close``."""
    got, want = got.float(), want.float()
    if what.endswith("fp32"):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4, msg=what)
        return
    mag = want.abs()
    row_share = 2**-7 if what.startswith("o ") else 2**-10
    tol = row_share * mag.amax(-1, keepdim=True) + 1e-5 * mag.max() + 2**-7 * mag
    bad = (got - want).abs() > tol
    assert not bad.any(), f"{what}: {int(bad.sum())} of {bad.numel()} elements off"


FLASH_CASES = [  # (B, S, H, KV, dh, window, dtype, plain chunk)
    (1, 256, 4, 4, 16, None, torch.float32, 64),      # rep 1
    (2, 320, 8, 2, 64, 100, torch.bfloat16, 64),      # rep 4, window < S
    (1, 512, 12, 1, 128, 1024, torch.float32, 128),   # rep 12, window >= S
    (1, 192, 24, 2, 128, None, torch.bfloat16, 64),   # the main path's heads
    (2, 96, 4, 1, 64, 7, torch.float32, 32),          # S not a multiple of the 64-row tile
    (1, 160, 12, 1, 16, 33, torch.bfloat16, 32),      # rep 12, ragged S, window
    (1, 4096, 24, 2, 128, 4096, torch.bfloat16, 512),  # the training shape
    (2, 1000, 24, 2, 128, 300, torch.bfloat16, 125),  # tensor cores: B = 2, ragged S, window < S
    (1, 160, 8, 2, 8, None, torch.float32, 32),       # dh 8 (a reduced config's)
    (2, 96, 8, 2, 8, 33, torch.bfloat16, 32),         # dh 8, bf16, window
    (1, 320, 6, 2, 128, None, torch.bfloat16, 64),    # rep 3: the forward's head group is 1
    (1, 256, 4, 4, 64, 100, torch.bfloat16, 64),      # tensor cores at dh 64, rep 1
]


@pytest.mark.parametrize("b,s,h,kv,dh,window,dtype,chunk", FLASH_CASES)
def test_flash_attn_kernels_match_plain(dev, b, s, h, kv, dh, window, dtype, chunk):
    from repro_torch.kernels.flash_attn import kernel, ref

    rng = np.random.default_rng(s + h + dh)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, dtype)
                   for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh), (b, s, h, dh)))
    counts = [c.count for c in (kernel.fwd_launches, kernel.dq_launches, kernel.dkv_launches)]
    o_k, lse_k = kernel.flash_fwd_kernel(q, k, v, window)
    o_p, lse_p = ref.flash_fwd(q, k, v, window, chunk, chunk)
    dq_k, delta_k = kernel.flash_bwd_dq_kernel(q, k, v, o_p, do, lse_p, window)
    dk_k, dv_k = kernel.flash_bwd_dkv_kernel(q, k, v, do, lse_p, delta_k, window)
    torch.cuda.synchronize()
    assert [c.count for c in (kernel.fwd_launches, kernel.dq_launches,
                              kernel.dkv_launches)] == [n + 1 for n in counts]
    dq_p, delta_p = ref.flash_bwd_dq(q, k, v, o_p, do, lse_p, window, chunk, chunk)
    dk_p, dv_p = ref.flash_bwd_dkv(q, k, v, do, lse_p, delta_p, window, chunk, chunk)
    tag = "fp32" if dtype == torch.float32 else "bf16"
    _flash_close(o_k, o_p, f"o {tag}")
    torch.testing.assert_close(lse_k, lse_p, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(delta_k, delta_p, atol=1e-3, rtol=1e-5)
    for name, got, want in (("dq", dq_k, dq_p), ("dk", dk_k, dk_p), ("dv", dv_k, dv_p)):
        _flash_close(got, want, f"{name} {tag}")


def test_chunked_attention_launches_each_kernel_once(dev):
    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.models.transformer import attention as attn

    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
               .requires_grad_() for shape in ((1, 128, 4, 16), (1, 128, 2, 16), (1, 128, 2, 16)))
    counters = (kernel.fwd_launches, kernel.dq_launches, kernel.dkv_launches)
    before = [c.count for c in counters]
    o = attn.chunked_attention(q, k, v, window=50, q_chunk=64, kv_chunk=64)
    o.sum().backward()
    torch.cuda.synchronize()
    assert [c.count for c in counters] == [n + 1 for n in before]
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    attn.chunked_attention(q, k, v, window=50, q_chunk=64, kv_chunk=64,
                           use_kernel=False).sum().backward()
    assert [c.count for c in counters] == [n + 1 for n in before]
    for got, t in zip(grads, (q, k, v)):
        torch.testing.assert_close(got, t.grad, atol=1e-4, rtol=1e-4)


def test_bf16_backward_is_deterministic(dev):
    """Two tensor-core backward calls at the training shape give the same
    bits: the dk/dv pass sums its head groups' partials in a fixed order."""
    from repro_torch.kernels.flash_attn import kernel

    rng = np.random.default_rng(11)
    b, s, h, kv, dh, w = 1, 4096, 24, 2, 128, 4096
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                   .to(dev, torch.bfloat16)
                   for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh), (b, s, h, dh)))
    o, lse = kernel.flash_fwd_kernel(q, k, v, w)
    runs = []
    for _ in range(2):
        dq, delta = kernel.flash_bwd_dq_kernel(q, k, v, o, do, lse, w)
        runs.append((dq, delta, *kernel.flash_bwd_dkv_kernel(q, k, v, do, lse, delta, w)))
    torch.cuda.synchronize()
    for a, c in zip(*runs):
        assert torch.equal(a, c)


def test_bf16_forward_is_deterministic(dev):
    """Two tensor-core forward calls at the training shape give the same
    bits (no atomics; every row's sums in a fixed order)."""
    from repro_torch.kernels.flash_attn import kernel

    rng = np.random.default_rng(12)
    b, s, h, kv, dh, w = 1, 4096, 24, 2, 128, 4096
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(dev, torch.bfloat16)
               for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh)))
    runs = [kernel.flash_fwd_kernel(q, k, v, w) for _ in range(2)]
    torch.cuda.synchronize()
    for a, c in zip(*runs):
        assert torch.equal(a, c)


def test_chunked_attention_bf16_launches_each_kernel_once(dev):
    """The bf16 twin of the test above, at dh 128: autograd reaches the
    tensor-core forward and backward once per call.  Its gradients are held
    to the plain backward of the same forward outputs (the kernel's o and
    lse: the plain forward's o may round one element the other way) under
    the bf16 rule of ``_flash_close``."""
    from repro_torch.kernels.flash_attn import kernel, ref
    from repro_torch.models.transformer import attention as attn

    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               .to(dev, torch.bfloat16).requires_grad_()
               for shape in ((1, 256, 8, 128), (1, 256, 2, 128), (1, 256, 2, 128)))
    do = torch.from_numpy(rng.standard_normal((1, 256, 8, 128)).astype(np.float32)).to(
        dev, torch.bfloat16)
    counters = (kernel.fwd_launches, kernel.dq_launches, kernel.dkv_launches)
    before = [c.count for c in counters]
    o = attn.chunked_attention(q, k, v, window=100, q_chunk=128, kv_chunk=128)
    o.backward(do)
    torch.cuda.synchronize()
    assert [c.count for c in counters] == [n + 1 for n in before]
    with torch.no_grad():
        o_k, lse_k = kernel.flash_fwd_kernel(q, k, v, 100)
        assert torch.equal(o, o_k)
        want = ref.flash_bwd(q, k, v, o_k, lse_k, do, 100, 128, 128)
    for name, t, w in zip(("dq", "dk", "dv"), (q, k, v), want):
        _flash_close(t.grad, w, f"{name} bf16")


def test_bf16_backward_refuses_misaligned_tensors(dev):
    """The tensor-core passes copy 16-byte chunks of every row: a bf16
    tensor at dh 64 that starts 2 bytes off is refused before any launch,
    and nothing is counted."""
    from repro_torch.kernels.flash_attn import kernel

    shape = (1, 64, 4, 64)
    q, do = (torch.zeros(shape, dtype=torch.bfloat16, device=dev) for _ in range(2))
    k, v = (torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=dev) for _ in range(2))
    off = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(shape)
    lse = torch.zeros((1, 4, 64), dtype=torch.float32, device=dev)
    before = (kernel.dq_launches.count, kernel.dkv_launches.count)
    with pytest.raises(RuntimeError, match="misaligned"):
        kernel.flash_bwd_dq_kernel(off, k, v, q, do, lse)
    with pytest.raises(RuntimeError, match="misaligned"):
        kernel.flash_bwd_dkv_kernel(q, k, v, off, lse, lse)
    assert (kernel.dq_launches.count, kernel.dkv_launches.count) == before


def test_bf16_forward_refuses_misaligned_tensors(dev):
    """The tensor-core forward copies 16-byte chunks of every row: a bf16 q
    at dh 128 that starts 2 bytes off is refused before any launch (not sent
    to another kernel), and nothing is counted."""
    from repro_torch.kernels.flash_attn import kernel

    shape = (1, 64, 4, 128)
    k, v = (torch.zeros((1, 64, 2, 128), dtype=torch.bfloat16, device=dev) for _ in range(2))
    off = torch.zeros(int(np.prod(shape)) + 1, dtype=torch.bfloat16, device=dev)[1:].view(shape)
    before = kernel.fwd_launches.count
    with pytest.raises(RuntimeError, match="misaligned"):
        kernel.flash_fwd_kernel(off, k, v)
    assert kernel.fwd_launches.count == before


def test_flash_attn_refuses_what_it_does_not_take(dev):
    from repro_torch.kernels.flash_attn import kernel

    def qkv(dtype=torch.bfloat16, s=64, h=4, kv=2, dh=16):
        return (torch.zeros((1, s, h, dh), dtype=dtype, device=dev),
                torch.zeros((1, s, kv, dh), dtype=dtype, device=dev),
                torch.zeros((1, s, kv, dh), dtype=dtype, device=dev))

    before = kernel.fwd_launches.count
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        kernel.flash_fwd_kernel(*qkv(torch.float16))
    with pytest.raises(ValueError, match="head dims"):
        kernel.flash_fwd_kernel(*qkv(dh=48))
    with pytest.raises(ValueError, match="multiple of KV"):
        kernel.flash_fwd_kernel(*qkv(h=5))
    with pytest.raises(ValueError, match="window"):
        kernel.flash_fwd_kernel(*qkv(), window=0)
    q, k, v = qkv()
    with pytest.raises(ValueError, match="contiguous"):
        kernel.flash_fwd_kernel(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="one dtype"):
        kernel.flash_fwd_kernel(q, k.float(), v)
    assert kernel.fwd_launches.count == before


def test_reduced_train_step_kernels_match_plain(dev):
    """One train step of the reduced StarCoder2 config at S = 1024 (the
    chunked branch, window 16) with the kernels and with the plain version,
    from the same weights and data, all fp32 (no TF32).

    Held: loss and grad norm within ``rtol`` 1e-5; every leaf's gradient,
    read from AdamW's first moment (after one step it is (1 − b1) times the
    clipped gradient), within a relative L2 gap of 1e-5 (sums in another
    order; the H100 read at most 5.2e-7); and every leaf's weight change
    within a relative L2 gap of 1e-3 (read at most 2.4e-4).  The change is
    looser than the gradient because Adam divides by sqrt(v) + eps, which
    turns a last-bit gradient difference into a visible step difference
    where |g| is near eps (one embedding element of 8192 stepped 4.3e-6
    apart, 2% of its step of lr = 2e-4).  A missing or wrong update gives a
    gap of order one."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attn import kernel
    from repro_torch.launch.train import _lm_data
    from repro_torch.models.transformer import model as tm
    from repro_torch.training import AdamWConfig, make_train_step
    from repro_torch.tree import tree_leaves

    cfg = get_config("starcoder2-3b").reduced_cfg
    host = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batch = next(_lm_data(cfg, 2, 1024, device=dev))
    out, launched = [], []
    for use_kernel in (True, False):
        before = kernel.fwd_launches.count
        params = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict) else v.to(dev))
                  for k, v in host.items()}
        init, step = make_train_step(
            lambda p, b: tm.lm_loss(p, b["tokens"], b["loss_mask"], cfg, use_kernel=use_kernel),
            AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=3), n_microbatches=2)
        state, metrics = step(init(params), batch)
        out.append((metrics, tree_leaves(state["opt"]["m"]), tree_leaves(state["params"])))
        launched.append(kernel.fwd_launches.count - before)
    # 2 layers x 2 micro-batches, each layer's forward run again by remat
    assert launched == [2 * cfg.n_layers * 2, 0]
    (m_k, g_k, p_k), (m_p, g_p, p_p) = out
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(m_k[key], m_p[key], atol=0, rtol=1e-5)
    for a, b in zip(g_k, g_p):
        gap = ((a - b).norm() / b.norm()).item()
        assert gap <= 1e-5, gap
    lr_1 = float(m_k["lr"])
    assert 1e-4 <= lr_1 <= 1e-3, lr_1
    for a, b, before in zip(p_k, p_p, tree_leaves(host)):
        step_k, step_p = a.cpu() - before, b.cpu() - before
        assert step_p.abs().max().item() > lr_1 / 2  # the step moved the leaf
        gap = ((step_k - step_p).norm() / step_p.norm()).item()
        assert gap <= 1e-3, gap


# ------------------------------------------------------------ ell_spmm ----
ELL_CASES = [  # q, m, k, d, dtype, slab columns the plan takes (0: the l2 variant): the
    # chip_smoke regimes, odd widths (a partial last slab; D = 33 unaligned), M = 1, K = 1,
    # K past one 32-slot chunk, M where only 16-column slabs fit and past any slab
    # (fp32 and bf16); more blocks than SMs with 16-column, unaligned and bf16 slabs
    (64, 1024, 32, 128, torch.float32, 32), (32, 256, 16, 128, torch.float32, 32),
    (3, 100, 12, 48, torch.float32, 32), (2, 50, 4, 200, torch.float32, 32),
    (4, 1000, 40, 64, torch.float32, 32), (5, 17, 1, 33, torch.float32, 32),
    (3, 1, 3, 8, torch.float32, 32), (2, 300, 70, 128, torch.float32, 32),
    (3, 3000, 24, 128, torch.float32, 16), (2, 5000, 16, 40, torch.float32, 0),
    (2, 8000, 16, 128, torch.float32, 0), (40, 3000, 8, 64, torch.float32, 16),
    (150, 200, 8, 33, torch.float32, 32),
    (8, 256, 16, 128, torch.bfloat16, 64), (2, 50, 4, 200, torch.bfloat16, 64),
    (2, 3000, 8, 96, torch.bfloat16, 32), (3, 40, 5, 33, torch.bfloat16, 64),
    (100, 512, 16, 128, torch.bfloat16, 64), (2, 7000, 8, 128, torch.bfloat16, 0)]


def _ell_inputs(dev, q, m, k, d, dtype, feat_offset=0):
    """Features (starting ``feat_offset`` elements into their buffer), ids
    in [0, M] and a 70% mask, with ids of M and past M under a set mask,
    all-masked rows and an all-masked query."""
    rng = np.random.default_rng(q * m + k)
    flat = torch.from_numpy(rng.standard_normal(feat_offset + q * m * d).astype(np.float32))
    feat = flat.to(dev, dtype)[feat_offset:].view(q, m, d)
    nbr = torch.from_numpy(rng.integers(0, m + 1, (q, m, k)).astype(np.int32)).to(dev)
    msk = torch.from_numpy(rng.random((q, m, k)) < 0.7).to(dev)
    nbr[:, ::7, 0] = m
    nbr[:, ::5, -1] = m + 3
    msk[:, ::3, :] = False
    msk[-1] = False
    return feat, nbr, msk


@pytest.mark.parametrize("q,m,k,d,dtype,cols", ELL_CASES)
def test_ell_spmm_kernel_matches_plain(dev, q, m, k, d, dtype, cols):
    """Bit for bit: kernel and plain version add the same fp32 values in
    slot order and round once.  Ids of M (mask set) and past M, all-masked
    rows and an all-masked query count as the zero sentinel.  One launch,
    the plan's variant and slab width."""
    from repro_torch.kernels.ell_spmm import kernel, ops

    feat, nbr, msk = _ell_inputs(dev, q, m, k, d, dtype)
    before = kernel.launches.count
    got = ops.ell_aggregate(feat, nbr, msk)
    torch.cuda.synchronize()
    assert kernel.launches.count == before + 1 and got.dtype == dtype
    assert kernel.last_plan == kernel.ell_plan(q, m, k, d, dtype)
    assert kernel.last_plan.variant == (kernel.L2 if cols == 0 else kernel.SLAB)
    assert kernel.last_plan.cols == cols
    assert torch.equal(got, ops.ell_aggregate(feat, nbr, msk, use_kernel=False))
    assert not got[-1].any() and not got[:, ::3].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row_bytes", [128, 64])
def test_ell_spmm_every_slab_width_and_unaligned_features(dev, dtype, row_bytes):
    """Each slab width forced at one shape, on features 16-byte aligned and
    not (one element into their buffer: the slab is then staged with element
    copies), bit for bit against the plain version."""
    from repro_torch.kernels.ell_spmm import kernel, ops

    width = row_bytes // dtype.itemsize
    for offset in (0, 1):
        feat, nbr, msk = _ell_inputs(dev, 3, 700, 20, 3 * width + 8, dtype, feat_offset=offset)
        plan = kernel.ell_plan(3, 700, 20, feat.shape[2], dtype, cols=width)
        got = kernel.ell_aggregate_kernel(feat, nbr, msk, plan=plan)
        torch.cuda.synchronize()
        assert kernel.last_plan == plan and plan.grid == 3 * 4
        assert torch.equal(got, ops.ell_aggregate(feat, nbr, msk, use_kernel=False)), offset


def test_ell_spmm_slab_on_every_device(dev):
    """The slab kernel's shared-memory limit (past 48 KB) is a setting of
    each device: a launch on a second card after one on the first still
    raises it there.  Needs two cards."""
    from repro_torch.kernels.ell_spmm import kernel, ops

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")
    for i in (0, 1):
        with torch.cuda.device(i):
            feat, nbr, msk = _ell_inputs(torch.device("cuda", i), 4, 1024, 16, 128, torch.float32)
            got = ops.ell_aggregate(feat, nbr, msk)
            torch.cuda.synchronize()
            assert kernel.last_plan.smem_bytes > 48 * 1024
            assert torch.equal(got, ops.ell_aggregate(feat, nbr, msk, use_kernel=False)), i


# ------------------------------------------------------------ ivf_scan ----
IVF_CASES = [  # q, n, d, w, k, integer data: ragged W, W < a run, k past the 256-entry
    # lists (the tree merge), narrow W < k, k = W
    (4, 5000, 128, 18_112, 3, False), (64, 5000, 128, 18_112, 32, False),
    (6, 400, 16, 899, 23, True), (3, 200, 8, 300, 6, True), (2, 300, 40, 700, 300, False),
    (5, 100, 70, 5, 9, False), (1, 1, 4, 1, 1, False), (3, 300, 128, 20, 7, True),
    (2, 400, 128, 3000, 256, False), (2, 400, 128, 3000, 300, True), (1, 50, 8, 600, 600, True),
    (9, 1000, 130, 2000, 12, False)]


@pytest.mark.parametrize("q,n,d,w,k,integer", IVF_CASES)
def test_ivf_scan_kernel_matches_plain(dev, q, n, d, w, k, integer):
    """Scores bit for bit (the plain version sums every dot product in the
    kernel's order) and ids exact, against both plain arms: duplicate ids
    and duplicate rows tie, a row with no live slot returns the raw ids of
    its first slots (real ids at masked slots), sentinels never score."""
    from repro_torch.kernels.ivf_scan import kernel, ops

    rng = np.random.default_rng(q * w + k)
    draw = (lambda s: rng.integers(-3, 4, s)) if integer else rng.standard_normal
    emb = torch.from_numpy(draw((n, d)).astype(np.float32)).to(dev)
    emb[n // 2:n // 2 + n // 8] = emb[: n // 8].clone()  # duplicate rows
    qv = torch.from_numpy(draw((q, d)).astype(np.float32)).to(dev)
    cand = torch.from_numpy(rng.integers(0, n + 1, (q, w)).astype(np.int32)).to(dev)
    cand[:, : w // 3] = cand[:, w // 3: 2 * (w // 3)]  # duplicate ids
    cmask = torch.from_numpy(rng.random((q, w)) < 0.6).to(dev) & (cand < n)
    cmask[-1] = False
    if q > 2:  # a row whose live slots all lie in its last block's last run
        cmask[0, :max(0, w - 20)] = False
    before = kernel.launches.count
    s_k, i_k = ops.ivf_candidate_scan(qv, emb, cand, cmask, k)
    torch.cuda.synchronize()
    assert kernel.launches.count == before + 1
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    assert kernel.last_plan == kernel.launch_plan(q, w, min(k, w), sm)
    assert s_k.shape == i_k.shape == (q, k)
    for tiled in (False, True):
        s_p, i_p = ops.ivf_candidate_scan(qv, emb, cand, cmask, k, tiled=tiled, c_blk=256,
                                          use_kernel=False)
        assert torch.equal(s_k, s_p) and torch.equal(i_k, i_p), tiled
    assert torch.equal(i_k[-1, :min(k, w)], cand[-1, :min(k, w)])


def test_new_kernels_refuse_bad_inputs(dev):
    from repro_torch.kernels.ell_spmm import ops as eops
    from repro_torch.kernels.ivf_scan import kernel as ikernel

    feat = torch.zeros((1, 4, 8), dtype=torch.float16, device=dev)
    idx = torch.zeros((1, 4, 2), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="fp32/bf16"):
        eops.ell_aggregate(feat, idx, idx.bool())
    q = torch.zeros((1, 4), device=dev)
    cand = torch.zeros((1, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="k="):
        ikernel.ivf_scan_kernel(q, torch.zeros((5, 4), device=dev), cand, cand.bool(), 9)
    with pytest.raises(ValueError, match="int32"):
        ikernel.ivf_scan_kernel(q, torch.zeros((5, 4), device=dev), cand.long(), cand.bool(), 1)


# ---------------------------------------------------- the index kinds ----
def test_index_kinds_on_the_card_match_the_cpu(dev):
    """IVF and sharded IVF built on the CPU, moved to the card: the card's
    search (ivf_scan / topk_sim kernels) equals the CPU's plain search, ids
    exactly, scores within 1e-6 (the centroid probe is a cuBLAS product on
    the card).  kmeans on the card twice gives the same bits; sharded brute
    ids equal brute ids on the card."""
    from repro_torch.core import indexing as ix
    from repro_torch.core.sharding import ShardedIndex
    from repro_torch.graph import generators
    from repro_torch.kernels.ivf_scan import kernel

    g = generators.citation_graph(6000, seed=4, with_text=False)
    q = g.node_feat[np.random.default_rng(1).choice(6000, 8)]
    for build in (lambda d: ix.IVFIndex.build(g.node_feat, n_clusters=16, device=d),
                  lambda d: ShardedIndex.build(g.node_feat, n_shards=3, inner="ivf",
                                               n_clusters=8, device=d)):
        cpu = build("cpu")
        card = type(cpu)(**{f: (v.to(dev) if torch.is_tensor(v) else v)
                            for f, v in vars(cpu).items()})
        before = kernel.launches.count
        s_c, i_c = card.search(q, 10)
        assert kernel.launches.count > before
        s_h, i_h = cpu.search(q, 10)
        assert torch.equal(i_c.cpu(), i_h)
        assert (s_c.cpu() - s_h).abs().max().item() <= 1e-6
    a, b = (ix.IVFIndex.build(g.node_feat, n_clusters=16, device=dev) for _ in range(2))
    assert torch.equal(a.centroids, b.centroids) and torch.equal(a.lists, b.lists)
    bs, bi = ix.BruteIndex.build(g.node_feat, device=dev).search(q, 9)
    ss, si = ShardedIndex.build(g.node_feat, n_shards=7, device=dev).search(q, 9)
    assert torch.equal(si, bi) and (ss - bs).abs().max().item() <= 1e-6


def test_ivf_serve_on_the_card_matches_the_cpu(dev):
    """One reduced ``--index ivf`` serve on the card and on the CPU, with
    the same weights: retrieved nodes, prompts and tokens equal."""
    import argparse

    from repro_torch.configs import get_config
    from repro_torch.kernels.ivf_scan import kernel
    from repro_torch.launch.serve import _serve_rag

    cfg = get_config("starcoder2-3b").reduced_cfg
    args = dict(requests=6, slots=4, max_new=6, nodes=3000, index="ivf", shards=None,
                retrieval="auto", cache_policy="lru")
    before = kernel.launches.count
    card = _serve_rag(cfg, argparse.Namespace(**args, device="cuda"))
    assert kernel.launches.count - before == card["retrieval_batches"] > 0
    p = card["params"]
    host = {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v.cpu())
            for k, v in p.items()}
    cpu = _serve_rag(cfg, argparse.Namespace(**args, device="cpu"), params=host)
    runs = [{r.uid: r for r in out["done"]} for out in (card, cpu)]
    assert len(runs[0]) == 6
    for uid, a in runs[0].items():
        b = runs[1][uid]
        assert np.array_equal(a.retrieved_nodes, b.retrieved_nodes), uid
        assert np.array_equal(a.prompt_ids, b.prompt_ids), uid
        assert a.out_tokens == b.out_tokens, uid


def _reduced_serve_args(**kw):
    import argparse

    base = dict(requests=12, slots=4, max_new=6, nodes=3000, index="brute", shards=None,
                retrieval="auto", cache_policy="lru", cache_len=112)
    return argparse.Namespace(**dict(base, **kw))


def _host_params(p):
    return {k: ({n: t.cpu() for n, t in v.items()} if isinstance(v, dict) else v.cpu())
            for k, v in p.items()}


def _serve_card_and_cpu(cfg, q_ids, **kw):
    from repro_torch.launch.serve import _serve_rag

    card = _serve_rag(cfg, _reduced_serve_args(device="cuda", **kw), q_ids=q_ids)
    cpu = _serve_rag(cfg, _reduced_serve_args(device="cpu", **kw), q_ids=q_ids,
                     params=_host_params(card["params"]))
    return card, cpu


def _same_serve(card, cpu):
    """Tokens, retrievals, prompts, truncated flags, the final allocator
    state and the pin counters of two serves agree exactly."""
    runs = [{r.uid: r for r in out["done"]} for out in (card, cpu)]
    assert sorted(runs[0]) == sorted(runs[1])
    for uid, a in runs[0].items():
        b = runs[1][uid]
        assert np.array_equal(a.retrieved_nodes, b.retrieved_nodes), uid
        assert np.array_equal(a.prompt_ids, b.prompt_ids), uid
        assert (a.out_tokens, a.truncated) == (b.out_tokens, b.truncated), uid
    ea, eb = card["engine"].engine, cpu["engine"].engine
    for name in ("table", "free", "n_free", "ref"):
        assert torch.equal(getattr(ea.cache, name).cpu(), getattr(eb.cache, name)), name
    sa, sb = card["stats"], cpu["stats"]
    for key in ("hits", "misses", "truncations", "kv_shared_admits", "kv_reused_tokens",
                "kv_cow_copies", "kv_pins", "kv_releases", "kv_pinned_blocks",
                "pool_high_water_blocks"):
        assert sa[key] == sb[key], key


def test_paged_share_continuous_serve_matches_the_cpu(dev):
    """A reduced paged + prefix-share + continuous serve (4 repeated
    queries; a pool that holds every pin, so each repeat shares) on the card
    and on the CPU with the same weights."""
    from repro_torch.configs import get_config

    cfg = get_config("starcoder2-3b").reduced_cfg
    q_ids = np.r_[np.arange(8) * 37, np.arange(4) * 37]
    card, cpu = _serve_card_and_cpu(cfg, q_ids, paged_kv=True, prefix_share=True,
                                    admission="continuous", pool_blocks=96)
    _same_serve(card, cpu)
    assert card["stats"]["kv_shared_admits"] == 4


def test_kv_quant_decode_on_the_card_matches_the_cpu(dev):
    """int8 KV at the reduced fp32 config, both arenas: the card's tokens
    equal the CPU's.  The fp32 K/V rows going into the quantization come
    from GEMMs that sum in another order on each device, so a row's int8
    value may differ by one level where it straddles a rounding boundary,
    and a bf16 scale by one bf16 ulp."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import model as tm
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced_cfg, kv_quant=True)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card_params = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict) else v.to(dev))
                   for k, v in params.items()}
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, cfg.vocab, int(rng.integers(5, 40))).astype(np.int32)
               for _ in range(6)]
    for paged in (False, True):
        outs, caches = [], []
        for p, d in ((card_params, "cuda"), (params, "cpu")):
            eng = ServeEngine(p, cfg, slots=3, cache_len=64, paged_kv=paged, device=d)
            for u, ids in enumerate(prompts):
                eng.submit(Request(uid=u, prompt_ids=ids, max_new_tokens=12))
            outs.append({r.uid: r.out_tokens for r in eng.run_to_completion()})
            caches.append(eng.cache)
        assert outs[0] == outs[1], paged
        for name in ("k", "v"):
            diff = getattr(caches[0], name).cpu().int() - getattr(caches[1], name).int()
            assert diff.abs().max().item() <= 1, (paged, name)
        for name in ("k_scale", "v_scale"):
            torch.testing.assert_close(getattr(caches[0], name).cpu(), getattr(caches[1], name),
                                       rtol=2**-7, atol=0)


def test_host_mirrors_equal_the_card_allocator_after_churn(dev):
    """Waves of requests through a pool that gates admission and truncates,
    with prefix sharing: after every step the engine's host mirrors equal
    the allocator's tensors on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import model as tm
    from repro_torch.serving.cache import CachedRetrieval
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = get_config("starcoder2-3b").reduced_cfg
    params = tm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = ServeEngine(params, cfg, slots=3, cache_len=48, paged_kv=True, block_size=8,
                      pool_blocks=9, prefix_share=True, device=dev)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, cfg.vocab, int(n)).astype(np.int32) for n in (13, 7, 20, 9)]
    z = np.empty(0, np.int32)
    entries = [CachedRetrieval(nodes=z, mask=np.empty(0, bool), dist=z, seeds=z)
               for _ in prompts]
    truncated = 0
    for wave in range(4):
        for u, (p, e) in enumerate(zip(prompts, entries)):
            eng.submit(Request(uid=10 * wave + u, prompt_ids=p, max_new_tokens=30, pin_to=e,
                               shared_prefix=e if e.kv_blocks is not None else None))
        while eng.queue or eng.live.any():
            truncated += sum(r.truncated for r in eng.step())
            depth = len(eng._free_stack)
            assert int(eng.cache.n_free) == depth
            assert eng.cache.free[:depth].cpu().tolist() == eng._free_stack
            assert eng.cache.ref.cpu().tolist() == eng._ref_host.tolist()
            table = eng.cache.table.cpu().numpy()
            for i, blks in enumerate(eng._slot_blocks):
                assert table[i, :len(blks)].tolist() == blks
                assert (table[i, len(blks):] == -1).all()
    assert truncated > 0 and eng.kv_shared_admits > 0


@pytest.mark.parametrize("paged,quant", [(False, False), (True, False), (False, True),
                                         (True, True)])
def test_spec_decode_on_the_card_matches_one_token_and_the_cpu(dev, paged, quant):
    """Self-speculative decode at the reduced fp32 config (windows 2 and 5;
    repetitive prompts, so drafts are accepted): the card's spec tokens
    equal the card's one-token tokens and the CPU's spec tokens, and the
    draft counters agree across devices."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import model as tm
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced_cfg, kv_quant=quant)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    card_params = {k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict) else v.to(dev))
                   for k, v in params.items()}
    rng = np.random.default_rng(4)
    prompts = [np.tile(rng.integers(1, cfg.vocab, int(rng.integers(2, 5))), 8)[:int(n)]
               .astype(np.int32) for n in rng.integers(6, 30, 7)]
    for window in (2, 5):
        outs, stats = [], []
        for p, d, spec in ((card_params, "cuda", True), (card_params, "cuda", False),
                           (params, "cpu", True)):
            eng = ServeEngine(p, cfg, slots=3, cache_len=64, paged_kv=paged, block_size=8,
                              spec_decode=spec, draft_window=window, device=d)
            for u, ids in enumerate(prompts):
                eng.submit(Request(uid=u, prompt_ids=ids, max_new_tokens=20))
            outs.append({r.uid: (r.out_tokens, r.truncated) for r in eng.run_to_completion()})
            stats.append(eng.decode_stats())
        assert outs[0] == outs[1] == outs[2], (paged, quant, window)
        for key in ("decode_steps", "draft_proposed", "draft_accepted"):
            assert stats[0][key] == stats[2][key], key
        assert stats[0]["decode_steps"] <= stats[1]["decode_steps"]


def test_spec_host_mirrors_equal_the_card_allocator(dev):
    """Speculative decode through a pool that gates admission and truncates
    (W-row windows): after every step the host mirrors equal the
    allocator's tensors on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import model as tm
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = get_config("starcoder2-3b").reduced_cfg
    params = tm.init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    eng = ServeEngine(params, cfg, slots=3, cache_len=48, paged_kv=True, block_size=4,
                      pool_blocks=16, spec_decode=True, draft_window=5, device=dev)
    rng = np.random.default_rng(9)
    for u in range(8):
        eng.submit(Request(uid=u, prompt_ids=rng.integers(1, cfg.vocab, int(rng.integers(5, 20)))
                           .astype(np.int32), max_new_tokens=30))
    truncated = 0
    while eng.queue or eng.live.any():
        truncated += sum(r.truncated for r in eng.step())
        depth = len(eng._free_stack)
        assert int(eng.cache.n_free) == depth
        assert eng.cache.free[:depth].cpu().tolist() == eng._free_stack
        assert eng.cache.ref.cpu().tolist() == eng._ref_host.tolist()
        table = eng.cache.table.cpu().numpy()
        for i, blks in enumerate(eng._slot_blocks):
            assert table[i, :len(blks)].tolist() == blks
            assert (table[i, len(blks):] == -1).all()
    assert truncated > 0 and eng._free_host == 16


# ------------------------------------------------ prefetch on a side stream ---
SLEEP_CYCLES = 1_000_000_000  # torch.cuda._sleep: ~0.5 s at the H100's clocks


def _small_pipe(dev, n=3000, mode="dense", index="brute"):
    """A retrieval pipeline on ``dev`` (dense mode: no host sync in a wave)."""
    from repro_torch.core.pipeline import PipelineConfig, RGLPipeline, index_from_config
    from repro_torch.graph import generators
    from repro_torch.graph.ell import csr_to_ell

    g = generators.citation_graph(n, avg_deg=8, seed=0)
    ell = csr_to_ell(g, device=dev)
    pcfg = PipelineConfig(k_seeds=3, max_nodes=16, filter_budget=6, retrieval_mode=mode,
                          index_kind=index)
    return g, RGLPipeline(graph=ell, index=index_from_config(ell.node_feat, pcfg, device=dev),
                          node_emb=ell.node_feat, config=pcfg, device=dev)


def _reqs(g, ids):
    from repro_torch.serving.rag_engine import RAGRequest

    return [RAGRequest(uid=i, query_emb=g.node_feat[q], query_text="q") for i, q in enumerate(ids)]


def test_prefetch_readiness_reads_the_side_streams_event(dev):
    """Work queued on the prefetcher's side stream ahead of a launch holds
    the wave: ``launch`` returns at once (dense mode syncs nothing),
    ``ready_index()`` is None while the side stream sleeps, and ``collect()``
    then blocks on the event and returns the entries a retrieval on the
    current stream gives."""
    import time

    from repro_torch.serving.cache import RetrievalCache
    from repro_torch.serving.prefetch import AdmissionPrefetcher

    g, pipe = _small_pipe(dev)
    p = AdmissionPrefetcher(pipe, RetrievalCache(), wave_size=4)
    ids = [5, 77, 300, 1234]
    p.launch(_reqs(g, [9]))  # builds the kernels and warms the stream
    p.collect()
    side = p.side_stream()
    assert side is not None and side != torch.cuda.current_stream(dev)
    with torch.cuda.stream(side):
        torch.cuda._sleep(SLEEP_CYCLES)
    t0 = time.perf_counter()
    p.launch(_reqs(g, ids))
    launch_s = time.perf_counter() - t0
    assert p.ready_index() is None and launch_s < 0.1, launch_s
    got = p.collect()
    want = pipe.retrieve_many(g.node_feat[ids], batch_size=4)
    for row, (r, e, err) in enumerate(got):
        assert err is None and r.uid == row
        assert np.array_equal(e.nodes, want.nodes[row].cpu().numpy())
        assert np.array_equal(e.mask, want.mask[row].cpu().numpy())
        assert np.array_equal(e.seeds, want.seeds[row].cpu().numpy())
    assert p.block_seconds > 0.1 and p.cache.inflight_count == 0


def test_timed_out_wave_keeps_its_pinned_buffers_until_its_event(dev):
    """A wave that times out behind a sleeping side stream fails closed; its
    pinned buffers stay held (and are not handed to the next launch) until
    its event completes, and then hold the wave's results."""
    from repro_torch.serving.cache import RetrievalCache
    from repro_torch.serving.prefetch import AdmissionPrefetcher

    g, pipe = _small_pipe(dev)
    p = AdmissionPrefetcher(pipe, RetrievalCache(), wave_size=4, retrieval_timeout_s=0.05)
    p.launch(_reqs(g, [9]))
    p.collect()
    side = p.side_stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(SLEEP_CYCLES)
    p.launch(_reqs(g, [5, 77]))
    out = p.collect()
    assert all(e is None and err.startswith("timeout") for _, e, err in out)
    assert p.timeouts == 1 and p.failures == 2 and p.cache.inflight_count == 0
    assert len(p._abandoned) == 1
    held = p._abandoned[0]
    held_ptrs = {a.host.data_ptr() for a in held}
    assert not held[0].event.query()
    wave = p.launch(_reqs(g, [300, 1234]))  # behind the sleep too
    assert not held_ptrs & {a.host.data_ptr() for a in wave.arrs}
    assert p._abandoned == [held]
    side.synchronize()
    want = pipe.retrieve_many(g.node_feat[[5, 77]], batch_size=4)
    assert np.array_equal(held[0].host.numpy(), want.nodes.cpu().numpy())
    p.collect()
    p.launch(_reqs(g, [42]))  # the next launch lets the completed landing go
    assert p._abandoned == []
    p.collect()


@pytest.mark.parametrize("admission", ["wave", "continuous"])
def test_prefetched_serve_matches_sync_and_the_cpu(dev, admission, monkeypatch):
    """A reduced fp32 prefetched serve (auto retrieval, 12 requests, 4
    repeats) on the card: tokens, retrievals, prompts and cache totals equal
    the card's sync serve and the CPU's prefetched serve, and no
    device-wide sync runs on the serve path."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import _serve_rag

    cfg = get_config("starcoder2-3b").reduced_cfg
    q_ids = np.r_[np.arange(8) * 37, np.arange(4) * 37]
    sync = _serve_rag(cfg, _reduced_serve_args(device="cuda", admission=admission), q_ids=q_ids)

    def no_device_sync(*a, **k):
        raise AssertionError("torch.cuda.synchronize on the serve path")

    monkeypatch.setattr(torch.cuda, "synchronize", no_device_sync)
    card = _serve_rag(cfg, _reduced_serve_args(device="cuda", admission=admission, prefetch=True),
                      q_ids=q_ids, params=sync["params"])
    monkeypatch.undo()
    cpu = _serve_rag(cfg, _reduced_serve_args(device="cpu", admission=admission, prefetch=True),
                     q_ids=q_ids, params=_host_params(sync["params"]))
    runs = [{r.uid: r for r in out["done"]} for out in (card, sync, cpu)]
    for uid, a in runs[0].items():
        for b in (runs[1][uid], runs[2][uid]):
            assert np.array_equal(a.retrieved_nodes, b.retrieved_nodes), uid
            assert np.array_equal(a.prompt_ids, b.prompt_ids), uid
            assert a.out_tokens == b.out_tokens, uid
    for key in ("hits", "misses", "retrieval_batches", "overlap_steps", "overlap_tokens"):
        assert card["stats"][key] == cpu["stats"][key], key
    assert card["stats"]["prefetch"] and card["stats"]["prefetch_waves"] > 0
    assert (card["stats"]["hits"], card["stats"]["misses"]) == \
        (sync["stats"]["hits"], sync["stats"]["misses"])


@pytest.mark.parametrize("index,mode", [("brute", "dense"), ("brute", "compact"),
                                        ("ivf", "dense")])
def test_concurrent_retrievals_on_two_streams_match_one_at_a_time(dev, index, mode):
    """Two retrieval waves queued at once on two streams (the kernels'
    scratch and ``topk_merge``'s workspace per stream) give the ids, masks
    and distances that one wave at a time on the current stream gives."""
    g, pipe = _small_pipe(dev, n=20_000, mode=mode, index=index)
    rng = np.random.default_rng(3)
    qs = [g.node_feat[rng.choice(20_000, 64, replace=False)] for _ in range(2)]
    want = [pipe.retrieve_many(q, batch_size=64) for q in qs]
    streams = [torch.cuda.Stream(dev) for _ in qs]
    cur = torch.cuda.current_stream(dev)
    got = []
    for s, q in zip(streams, qs):
        s.wait_stream(cur)
    for s, q in zip(streams, qs):
        with torch.cuda.stream(s):
            got.append(pipe.retrieve_many(q, batch_size=64))
    for s in streams:
        s.synchronize()
    for a, b in zip(got, want):
        for name in ("seeds", "nodes", "mask", "dist"):
            assert torch.equal(getattr(a, name), getattr(b, name)), (index, mode, name)
