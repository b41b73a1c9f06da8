"""Port sharded index vs the reference and vs the port's own brute index:
the hierarchical top-k merge, sharded brute search (logical shards on one
device), sharded IVF search on the reference's per-shard centroids and
lists, and the reference's recall / empty-shard / build_index cases.

Tolerances: ids exact everywhere, tie order included.  Scores within
``atol = 1e-6`` (a few ulp of unit-vector dot products): the reference's
own sharded scores are not bitwise equal to its brute scores (ROADMAP
Queue 3), so no score is held bitwise across layouts.  The merge itself only
selects, so its scores are held bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import BruteIndex as RefBruteIndex
from repro.core import ShardedIndex as RefShardedIndex
from repro.core import hierarchical_topk_merge as ref_merge
from repro_torch.core.indexing import BruteIndex, build_index
from repro_torch.core.pipeline import PipelineConfig, index_from_config
from repro_torch.core.sharding import ShardedIndex, hierarchical_topk_merge

ATOL = 1e-6


def T(a):
    return torch.from_numpy(np.array(a))


def _same(s, i, ws, wi):
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(i.numpy(), np.asarray(wi))


# ---------------------------------------------------------------- merge ----
@pytest.mark.parametrize("s,q,w,k", [(2, 3, 5, 4), (5, 2, 7, 9), (8, 4, 3, 6), (1, 2, 6, 3),
                                     (3, 2, 4, 20), (7, 3, 2, 5)])
def test_merge_matches_reference(s, q, w, k):
    """Odd shard counts pad a level with (-inf, INT32_MAX); -inf entries and
    equal scores are ordered by id."""
    rng = np.random.default_rng(s * 100 + w)
    scores = rng.standard_normal((s, q, w)).astype(np.float32)
    scores[0, :, -1] = -np.inf
    scores[-1, :, 0] = scores[0, :, 0]  # a tie across shards
    ids = rng.permutation(s * q * w).reshape(s, q, w).astype(np.int32)
    ws, wi = ref_merge(jnp.asarray(scores), jnp.asarray(ids), k)
    ms, mi = hierarchical_topk_merge(T(scores), T(ids), k)
    np.testing.assert_array_equal(ms.numpy().view(np.uint32), np.asarray(ws).view(np.uint32))
    np.testing.assert_array_equal(mi.numpy(), np.asarray(wi))
    flat_s = scores.transpose(1, 0, 2).reshape(q, -1)
    flat_i = ids.transpose(1, 0, 2).reshape(q, -1)
    for qi in range(q):
        order = np.lexsort((flat_i[qi], -flat_s[qi]))[:min(k, s * w)]
        np.testing.assert_array_equal(mi[qi, :len(order)].numpy(), flat_i[qi][order])


def test_merge_breaks_ties_by_id():
    s, q, w, k = 4, 2, 3, 5
    perm = np.tile(np.random.default_rng(1).permutation(s * w), (q, 1))
    ids = T(perm.reshape(q, s, w).transpose(1, 0, 2).astype(np.int32))
    _, mi = hierarchical_topk_merge(torch.ones((s, q, w)), ids, k)
    np.testing.assert_array_equal(mi.numpy(), np.tile(np.arange(k), (q, 1)))


# ------------------------------------------------------- sharded brute ----
@pytest.mark.parametrize("n,n_shards,k", [(101, 3, 7), (96, 4, 5), (60, 7, 60), (2500, 2, 11),
                                          (5, 4, 5), (700, 7, 9)])
def test_sharded_brute_matches_brute(n, n_shards, k):
    """N not divisible by S, k == N, an empty trailing shard (5 rows in 4
    shards of 2), S = 7."""
    rng = np.random.default_rng(n + n_shards)
    emb = rng.standard_normal((n, 32)).astype(np.float32)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    bs, bi = BruteIndex.build(emb, device="cpu").search(q, k)
    idx = ShardedIndex.build(emb, n_shards=n_shards, device="cpu")
    assert idx.n_shards == min(n_shards, n)
    ss, si = idx.search(q, k)
    _same(ss, si, bs, bi)
    _same(ss, si, *RefShardedIndex.build(emb, n_shards=n_shards).search(jnp.asarray(q), k))
    _same(ss, si, *RefBruteIndex.build(emb).search(jnp.asarray(q), k))


def test_sharded_brute_ties_with_duplicate_rows():
    """Rows i, i + 40 and i + 80 are equal and fall in different shards: the
    merge gives the lowest global id first, as the unsharded scan does."""
    base = np.random.default_rng(2).standard_normal((40, 16)).astype(np.float32)
    emb = np.concatenate([base, base, base])
    q = base[:4].copy()
    bs, bi = BruteIndex.build(emb, device="cpu").search(q, 9)
    ss, si = ShardedIndex.build(emb, n_shards=5, device="cpu").search(q, 9)
    _same(ss, si, bs, bi)
    assert si[:, :3].tolist() == [[i, i + 40, i + 80] for i in range(4)]
    _same(ss, si, *RefBruteIndex.build(emb).search(jnp.asarray(q), 9))


# --------------------------------------------------------- sharded IVF ----
def _port_from_reference(r, devices=None):
    return ShardedIndex.from_shards(
        T(r.emb_shards), r.n_total, r.rows_per_shard, normalized=r.normalized, inner=r.inner,
        centroids=T(r.centroids), lists=T(r.lists), list_mask=T(r.list_mask), nprobe=r.nprobe,
        devices=devices, device="cpu")


@pytest.mark.parametrize("n,n_shards,n_clusters,nprobe,k", [
    (1200, 3, 8, 2, 10), (1000, 4, 16, 3, 7), (5, 4, 4, 4, 3), (333, 7, 4, 1, 40)])
def test_sharded_ivf_matches_reference_on_its_shards(n, n_shards, n_clusters, nprobe, k):
    rng = np.random.default_rng(n)
    emb = rng.standard_normal((n, 32)).astype(np.float32)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    r = RefShardedIndex.build(emb, n_shards=n_shards, inner="ivf", n_clusters=n_clusters,
                              nprobe=nprobe)
    ws, wi = r.search(jnp.asarray(q), k)
    s, i = _port_from_reference(r).search(q, k)
    _same(s, i, ws, wi)


def test_sharded_ivf_recall_vs_brute():
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((1200, 32)).astype(np.float32)
    q = rng.standard_normal((12, 32)).astype(np.float32)
    _, bi = BruteIndex.build(emb, device="cpu").search(q, 10)
    sivf = ShardedIndex.build(emb, n_shards=3, inner="ivf", n_clusters=8, nprobe=8, device="cpu")
    _, si = sivf.search(q, 10)  # nprobe == C: exhaustive in every shard
    rec = np.mean([len(set(si[r].tolist()) & set(bi[r].tolist())) / 10 for r in range(12)])
    assert rec >= 0.99, rec


def test_sharded_ivf_empty_trailing_shard():
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((5, 8)).astype(np.float32)
    q = rng.standard_normal((2, 8)).astype(np.float32)
    sv = ShardedIndex.build(emb, n_shards=4, inner="ivf", n_clusters=4, nprobe=4, device="cpu")
    s, i = sv.search(q, 3)
    assert int(i.max()) < 5 and torch.isfinite(s).all()
    bs, bi = BruteIndex.build(emb, device="cpu").search(q, 3)
    _same(s, i, bs, bi)  # every list probed in every shard: exact


def test_build_index_kinds_and_config_shards():
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((50, 8)).astype(np.float32)
    q = rng.standard_normal((3, 8)).astype(np.float32)
    bs, bi = BruteIndex.build(emb, device="cpu").search(q, 4)
    one = build_index(emb, kind="sharded", n_shards=1, device="cpu")
    _same(*one.search(q, 4), bs, bi)
    sivf = build_index(emb, kind="sharded_ivf", n_shards=2, n_clusters=4, nprobe=4, device="cpu")
    s2, i2 = sivf.search(q, 4)
    assert s2.shape == (3, 4) and int(i2.max()) < 50 and sivf.inner == "ivf"
    for kind in ("sharded", "sharded_ivf"):
        idx = index_from_config(emb, PipelineConfig(index_kind=kind, index_shards=3), device="cpu")
        assert isinstance(idx, ShardedIndex) and idx.n_shards == 3
    assert index_from_config(emb, PipelineConfig(index_kind="sharded"), device="cpu").n_shards == 1
    with pytest.raises(ValueError, match="unknown inner"):
        ShardedIndex.build(emb, inner="hnsw", device="cpu")


# ------------------------------------------------ the mesh of devices ----
@pytest.mark.parametrize("n_shards", range(1, 10))
def test_mesh_size_and_its_warning_match_the_reference(n_shards):
    """The largest divisor of n_shards within the devices, with the
    reference's warning where that collapses the mesh."""
    import warnings

    from repro.core.sharding import _mesh_size as ref_mesh_size
    from repro_torch.core.sharding import _mesh_size

    for n_dev in range(1, 9):
        with warnings.catch_warnings(record=True) as ref_w:
            warnings.simplefilter("always")
            want = ref_mesh_size(n_shards, n_dev)
        with warnings.catch_warnings(record=True) as got_w:
            warnings.simplefilter("always")
            got = _mesh_size(n_shards, n_dev)
        assert got == want, (n_shards, n_dev)
        assert [str(w.message) for w in got_w] == [str(w.message) for w in ref_w], (n_shards,
                                                                                  n_dev)


# the reference on a forced 4-device host mesh (the device count must be set
# before JAX starts, hence a subprocess, which runs this source too, without
# torch); cases (name, N, S, k), built from one seed on both sides
_MESH_CASES_SRC = """
import numpy as np
_MESH_CASES = [("2500-4-11", 2500, 4, 11), ("2501-8-5", 2501, 8, 5), ("60-7-60", 60, 7, 60),
               ("96-4-5", 96, 4, 5), ("empty_trailing", 5, 4, 5), ("duplicate_rows", 120, 5, 9)]


def _mesh_case(name, n, s, k):
    rng = np.random.default_rng(n * 10 + s)
    if name == "duplicate_rows":  # rows i, i + 40, i + 80 tie across shards
        base = rng.standard_normal((40, 16)).astype(np.float32)
        return np.concatenate([base, base, base]), base[:4].copy()
    d = 8 if n < 10 else 32
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((5, d)).astype(np.float32))
"""
exec(_MESH_CASES_SRC)


_REF_MESH_SCRIPT = """
import numpy as np, jax, jax.numpy as jnp
from repro.core import ShardedIndex

assert jax.device_count() == 4, jax.device_count()
out = {{}}
for name, n, s, k in _MESH_CASES:
    emb, q = _mesh_case(name, n, s, k)
    idx = ShardedIndex.build(emb, n_shards=s)
    ss, si = idx.search(jnp.asarray(q), k)
    out[name + "/mesh"] = np.asarray(idx.mesh.size)
    out[name + "/scores"], out[name + "/ids"] = np.asarray(ss), np.asarray(si)
rng = np.random.default_rng(11)
emb = rng.standard_normal((1000, 32)).astype(np.float32)
q = rng.standard_normal((6, 32)).astype(np.float32)
r = ShardedIndex.build(emb, n_shards=4, inner="ivf", n_clusters=16, nprobe=3)
assert r.mesh.size == 4
s, i = r.search(jnp.asarray(q), 7)
out.update({{"ivf/q": q, "ivf/scores": np.asarray(s), "ivf/ids": np.asarray(i),
            "ivf/emb_shards": np.asarray(r.emb_shards), "ivf/centroids": np.asarray(r.centroids),
            "ivf/lists": np.asarray(r.lists), "ivf/list_mask": np.asarray(r.list_mask),
            "ivf/meta": np.asarray([r.n_total, r.rows_per_shard, r.nprobe])}})
np.savez({out!r}, **out)
print("REF_MESH_OK")
"""


@pytest.fixture(scope="module")
def ref_mesh(tmp_path_factory):
    import os
    import subprocess
    import sys

    path = str(tmp_path_factory.mktemp("ref_mesh") / "ref.npz")
    tests = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "").replace(
        "--xla_force_host_platform_device_count=4", "")
        + " --xla_force_host_platform_device_count=4").strip()
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(tests, "..", "src"),
                                         env.get("PYTHONPATH", "")])
    script = _MESH_CASES_SRC + _REF_MESH_SCRIPT.format(out=path)
    out = subprocess.run([sys.executable, "-c", script],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "REF_MESH_OK" in out.stdout, out.stderr[-2000:]
    with np.load(path) as z:
        return dict(z)


def _within_ulps(got: torch.Tensor, want: np.ndarray, ulps: int) -> None:
    """Finite scores within ``ulps`` ULP of the scores' scale, 1.0 (dot
    products of unit vectors; fp32's ULP there is 2**-23), -inf equal.  An
    ULP of each value would be no bound near 0: the reference's own sharded
    and brute scores of one near-zero pair differ by thousands of them."""
    a, b = got.numpy(), np.asarray(want)
    assert a.shape == b.shape
    finite = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), finite)
    gap = np.abs(a[finite] - b[finite]).max(initial=0.0)
    assert gap <= ulps * 2.0**-23, gap


@pytest.mark.parametrize("case", _MESH_CASES, ids=[c[0] for c in _MESH_CASES])
def test_sharded_over_four_devices_matches_the_reference_mesh(case, ref_mesh):
    """Four mesh positions (``devices=["cpu"] * 4``) against the reference's
    4-device host mesh: the same mesh size, ids exact, scores within 2 ULP at
    1.0 (the reference's own scores move by 1-2 ULP across layouts)."""
    name, n, s, k = case
    emb, q = _mesh_case(name, n, s, k)
    idx = ShardedIndex.build(emb, n_shards=s, devices=["cpu"] * 4, device="cpu")
    assert idx.mesh_size == int(ref_mesh[name + "/mesh"]) and idx.n_shards == min(s, n)
    ss, si = idx.search(q, k)
    np.testing.assert_array_equal(si.numpy(), ref_mesh[name + "/ids"])
    _within_ulps(ss, ref_mesh[name + "/scores"], 2)


def test_sharded_ivf_over_four_devices_on_the_reference_arrays(ref_mesh):
    """The reference's per-shard IVF state from its 4-device mesh, laid over
    four positions: ids exact."""
    n_total, rows, nprobe = (int(v) for v in ref_mesh["ivf/meta"])
    idx = ShardedIndex.from_shards(
        T(ref_mesh["ivf/emb_shards"]), n_total, rows, inner="ivf",
        centroids=T(ref_mesh["ivf/centroids"]), lists=T(ref_mesh["ivf/lists"]),
        list_mask=T(ref_mesh["ivf/list_mask"]), nprobe=nprobe, devices=["cpu"] * 4,
        device="cpu")
    assert idx.mesh_size == 4 and [b.shape[0] for b in idx.list_blocks] == [1] * 4
    s, i = idx.search(ref_mesh["ivf/q"], 7)
    np.testing.assert_array_equal(i.numpy(), ref_mesh["ivf/ids"])
    np.testing.assert_allclose(s.numpy(), ref_mesh["ivf/scores"], atol=ATOL, rtol=0)


@pytest.mark.parametrize("inner", ["brute", "ivf"])
def test_mesh_size_leaves_results_bit_equal(inner):
    """One device and four positions at the same n_shards: the same bits,
    brute and IVF (k-means runs per shard on its position's device)."""
    rng = np.random.default_rng(12)
    emb = rng.standard_normal((1003, 24)).astype(np.float32)
    q = rng.standard_normal((7, 24)).astype(np.float32)
    kw = dict(n_shards=8, inner=inner, n_clusters=8, nprobe=3, device="cpu")
    one = ShardedIndex.build(emb, devices=["cpu"], **kw)
    four = ShardedIndex.build(emb, devices=["cpu"] * 4, **kw)
    assert (one.mesh_size, four.mesh_size) == (1, 4)
    assert [b.shape[0] for b in four.emb_blocks] == [2] * 4
    for k in (1, 10, 60):
        (s1, i1), (s4, i4) = one.search(q, k), four.search(q, k)
        assert torch.equal(i1, i4) and torch.equal(s1.view(torch.int32), s4.view(torch.int32))
    if inner == "ivf":
        for f in ("centroids", "lists", "list_mask"):
            assert torch.equal(getattr(one, f), getattr(four, f)), f
    assert torch.equal(ShardedIndex.build(emb, device="cpu").emb_shards,
                       ShardedIndex.build(emb, devices=["cpu"], device="cpu").emb_shards)


@pytest.mark.parametrize("inner", ["brute", "ivf"])
def test_use_kernel_reaches_the_scan_ops(inner, monkeypatch):
    """``use_kernel`` goes to every shard's scan op: False takes the plain
    versions, True asks for the kernel (which refuses CPU tensors)."""
    from repro_torch.kernels.ivf_scan import ops as ivf_ops
    from repro_torch.kernels.topk_sim import ops as topk_ops

    rng = np.random.default_rng(13)
    emb = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    op = topk_ops if inner == "brute" else ivf_ops
    name = "topk_similarity" if inner == "brute" else "ivf_candidate_scan"
    seen = []
    real = getattr(op, name)
    monkeypatch.setattr(op, name, lambda *a, **kw: seen.append(kw["use_kernel"]) or real(*a, **kw))
    kw = dict(n_shards=4, inner=inner, n_clusters=4, devices=["cpu"] * 2, device="cpu")
    plain = ShardedIndex.build(emb, use_kernel=False, **kw)
    assert plain.search(q, 5)[1].shape == (3, 5) and seen == [False] * 4
    with pytest.raises(ValueError, match="CUDA device"):
        ShardedIndex.build(emb, use_kernel=True, **kw).search(q, 5)
    assert seen[4] is True


def test_mesh_devices_resolve_as_entry_points_do():
    """``devices=None`` on the CPU is the home device alone; a card that is
    not there raises as ``resolve_device`` does; 7 shards on 4 positions
    collapse to one, with the reference's warning."""
    from repro_torch.core.sharding import mesh_devices

    assert mesh_devices(None, torch.device("cpu")) == [torch.device("cpu")]
    with pytest.raises(RuntimeError):
        mesh_devices([f"cuda:{torch.cuda.device_count()}"], torch.device("cpu"))
    emb = np.random.default_rng(14).standard_normal((70, 8)).astype(np.float32)
    with pytest.warns(UserWarning, match="using a 1-device mesh"):
        idx = ShardedIndex.build(emb, n_shards=7, devices=["cpu"] * 4, device="cpu")
    assert idx.mesh_size == 1 and idx.emb_blocks[0].shape[0] == 7
