"""The port's checkpointing and crash-restart driver against the reference
(``repro.checkpoint``, ``repro.distributed.fault``): the twins of
``tests/test_checkpoint.py``, checkpoints crossing between the two packages
in both directions with equal bits (bf16 included) and equal manifests, a
save that an in-place update right after it cannot tear, and the rendezvous
assignment and restart driver equal to the reference's.  Each comparison
runs in one process: ``elastic_shard_assignment`` hashes str hosts with
Python's salted ``hash()``."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as ref_ckpt
from repro.distributed import fault as ref_fault
from repro_torch.checkpoint import (
    AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint,
)
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.distributed.fault import elastic_shard_assignment, run_with_restart
from repro_torch.training.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)),
        "nested": {"b": torch.from_numpy(rng.integers(0, 5, (3,)).astype(np.int32))},
    }


def _mixed(seed=0):
    """numpy leaves of a tree whose keys are not in sorted order, with
    fp32, int32 and bf16 (as bits) leaves and a list."""
    rng = np.random.default_rng(seed)
    return {
        "z": rng.standard_normal((5, 3)).astype(np.float32),
        "layers": [rng.integers(-9, 9, (4,)).astype(np.int32),
                   rng.standard_normal((2, 6)).astype(np.float32)],
        "a": {"w": rng.standard_normal((3, 7)).astype(np.float32), "step": np.int32(7)},
        "bf": rng.standard_normal((6, 2)).astype(np.float32),
    }


def _as_port(t):
    out = tree_map(lambda a: torch.from_numpy(np.array(a)), t)
    out["bf"] = out["bf"].to(torch.bfloat16)
    return out


def _as_ref(t):
    out = tree_map(jnp.asarray, t)
    out["bf"] = out["bf"].astype(jnp.bfloat16)
    return out


def _bits(x) -> np.ndarray:
    """The stored bits of a leaf of either package (bf16 as int16)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.itemsize == 2 and a.dtype.kind in "Vf" else a


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in _paths(sub, f"{prefix}{k}/").items()}
    if isinstance(tree, list):
        return {p: v for i, sub in enumerate(tree) for p, v in _paths(sub, f"{prefix}{i}/").items()}
    return {prefix[:-1]: tree}


# ------------------------------------------------ twins of test_checkpoint ---
def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    r, step = restore_checkpoint(str(tmp_path), t)
    assert step == 7
    assert torch.equal(r["a"], t["a"]) and torch.equal(r["nested"]["b"], t["nested"]["b"])
    assert r["nested"]["b"].dtype == torch.int32


def test_latest_step_and_overwrite(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    save_checkpoint(str(tmp_path), 3, t)
    assert latest_step(str(tmp_path)) == 3
    save_checkpoint(str(tmp_path), 3, _tree(seed=1))  # overwrite is atomic
    r, _ = restore_checkpoint(str(tmp_path), t, step=3)
    assert torch.equal(r["a"], _tree(seed=1)["a"])
    assert latest_step(str(tmp_path / "absent")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "absent"), t)


def test_no_tmp_dirs_left(tmp_path):
    save_checkpoint(str(tmp_path), 2, _tree())
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_async_checkpointer_gc(tmp_path):
    ac = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (10, 20, 30, 40):
        ac.save(s, _tree())
    ac.close()
    steps = sorted(
        int(d.split("_")[1]) for d in os.listdir(tmp_path) if d.startswith("step_")
    )
    assert steps == [30, 40]


def test_async_checkpointer_raises_a_write_error_on_close(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")  # a file where the checkpoint directory should be
    ac = AsyncCheckpointer(str(blocker), keep=2)
    ac.save(1, _tree())
    with pytest.raises(OSError):
        ac.close()


def test_restore_onto_named_device(tmp_path):
    """The one-device form of reshard-on-restore: ``device`` puts every leaf
    there, whatever the devices of ``like``; without it each leaf follows
    its ``like`` leaf (dtype included)."""
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    r, _ = restore_checkpoint(str(tmp_path), t, device=torch.device("cpu"))
    assert all(x.device == torch.device("cpu") for x in tree_leaves(r))
    like = {"a": torch.zeros((8, 4), dtype=torch.float64), "nested": {"b": torch.zeros(3)}}
    r, _ = restore_checkpoint(str(tmp_path), like)
    assert r["a"].dtype == torch.float64 and r["nested"]["b"].dtype == torch.float32
    np.testing.assert_array_equal(r["a"].numpy(), t["a"].numpy().astype(np.float64))


def test_restore_onto_sharding(tmp_path):
    """The reference's ``test_restore_onto_sharding`` twin: a device per
    leaf (the twin of ``SingleDeviceSharding``) puts that leaf there, ``None``
    leaves it to ``device``; dtypes still follow ``like``."""
    t = _tree()
    save_checkpoint(str(tmp_path), 1, t)
    sh = tree_map(lambda _: torch.device("cpu"), t)
    r, _ = restore_checkpoint(str(tmp_path), t, sharding_tree=sh)
    assert all(x.device == torch.device("cpu") for x in tree_leaves(r))
    assert torch.equal(r["a"], t["a"]) and torch.equal(r["nested"]["b"], t["nested"]["b"])
    like = {"a": torch.zeros((8, 4), dtype=torch.float64), "nested": {"b": torch.zeros(3)}}
    r, _ = restore_checkpoint(str(tmp_path), like, device="meta",
                              sharding_tree={"a": "meta", "nested": {"b": None}})
    assert r["a"].device.type == r["nested"]["b"].device.type == "meta"
    assert r["a"].dtype == torch.float64 and r["nested"]["b"].dtype == torch.float32
    r, _ = restore_checkpoint(str(tmp_path), t, sharding_tree={"a": torch.device("meta"),
                                                                "nested": {"b": None}})
    assert r["a"].device.type == "meta" and r["nested"]["b"].device.type == "cpu"
    with pytest.raises(TypeError, match="not a placement"):
        restore_checkpoint(str(tmp_path), t, sharding_tree={"a": 3, "nested": {"b": None}})


@pytest.mark.parametrize("rank", [0, 3])
def test_restore_onto_a_mesh_keeps_each_ranks_piece(tmp_path, rank):
    """A ``(DeviceMesh, named(mesh, spec))`` leaf under a fake 4-rank group
    (2 x 2, this process rank 0 or 3): each leaf is a DTensor of the saved
    global shape whose local piece is this rank's slice of the saved array,
    bit for bit (uneven rows, nested axes on one dim, replicated, bf16);
    no process group outlives the restore."""
    import torch.distributed as dist

    from repro_torch.distributed.policies import named
    from repro_torch.launch.dryrun import _fake_world
    from repro_torch.launch.mesh import make_mesh

    rng = np.random.default_rng(7)
    t = {"w": torch.from_numpy(rng.standard_normal((5, 6)).astype(np.float32)),
         "v": torch.from_numpy(rng.standard_normal((8, 3)).astype(np.float32)),
         "r": torch.from_numpy(rng.integers(0, 9, (4,)).astype(np.int32)),
         "b": torch.from_numpy(rng.standard_normal((6, 2)).astype(np.float32)).bfloat16()}
    save_checkpoint(str(tmp_path), 2, t)
    row, col = divmod(rank, 2)  # (data, model) coordinate
    want = {"w": t["w"][(0, 3)[row]:(3, 5)[row], 3 * col:3 * col + 3],  # 5 rows: 3 + 2
            "v": t["v"][2 * rank:2 * rank + 2], "r": t["r"], "b": t["b"][:, col:col + 1]}
    assert not dist.is_initialized()
    with _fake_world(4, rank=rank):
        mesh = make_mesh((2, 2), ("data", "model"))
        specs = {"w": ("data", "model"), "v": (("data", "model"), None), "r": (),
                 "b": (None, "model")}
        sh = {k: (mesh, named(mesh, spec)) for k, spec in specs.items()}
        r, step = restore_checkpoint(str(tmp_path), t, sharding_tree=sh)
        assert step == 2
        for k, x in r.items():
            assert tuple(x.shape) == tuple(t[k].shape) and x.placements == sh[k][1], k
            got = x.to_local()
            assert got.dtype == t[k].dtype and got.shape == want[k].shape, k
            assert torch.equal(got.view(torch.int16) if k == "b" else got,
                               want[k].view(torch.int16) if k == "b" else want[k]), k
    assert not dist.is_initialized()


def test_crash_restart_driver(tmp_path):
    """Simulated failure at step 17: training must resume from step 10."""
    calls = {"crashed": False}

    def step_fn(state, step):
        if step == 17 and not calls["crashed"]:
            calls["crashed"] = True
            raise RuntimeError("simulated node failure")
        return {"x": state["x"] + 1}

    def save_fn(state, step):
        save_checkpoint(str(tmp_path), step, state)

    def restore_fn():
        st = latest_step(str(tmp_path))
        state, _ = restore_checkpoint(str(tmp_path), {"x": torch.zeros(())}, step=st)
        return state, st

    state, restarts = run_with_restart(
        step_fn, save_fn, restore_fn, {"x": torch.zeros(())}, n_steps=25,
        checkpoint_every=10,
    )
    assert restarts == 1
    assert int(state["x"]) == 25  # every step effectively executed


def test_elastic_reassignment_stability():
    """Rendezvous hashing: removing a host only moves that host's shards."""
    hosts = list(range(8))
    a1 = elastic_shard_assignment(64, hosts)
    a2 = elastic_shard_assignment(64, [h for h in hosts if h != 3])
    moved = [s for s in range(64) if a1[s] != a2[s]]
    assert all(a1[s] == 3 for s in moved)
    assert all(a2[s] != 3 for s in range(64))


# ---------------------------------------- port and reference, same files ---
def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    host = _mixed()
    ref_ckpt.save_checkpoint(str(tmp_path), 5, _as_ref(host))
    like = tree_map(torch.zeros_like, _as_port(host))
    got, step = restore_checkpoint(str(tmp_path), like)
    assert step == 5
    want = _paths(_as_port(host))
    for p, leaf in _paths(got).items():
        assert leaf.dtype == want[p].dtype and leaf.shape == want[p].shape, p
        np.testing.assert_array_equal(_bits(leaf), _bits(want[p]), err_msg=p)
    assert got["bf"].dtype == torch.bfloat16


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    """The reference reads the port's files and gets the same bits (bf16
    as its raw ``V2`` records); the port's manifest and ``.npz`` keys equal
    the reference's for the same tree."""
    host = _mixed()
    save_checkpoint(str(tmp_path / "port"), 5, _as_port(host))
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 5, _as_ref(host))
    got, step = ref_ckpt.restore_checkpoint(str(tmp_path / "port"), _as_ref(host))
    assert step == 5
    want = _paths(_as_port(host))
    for p, leaf in _paths(got).items():
        np.testing.assert_array_equal(_bits(leaf), _bits(want[p]), err_msg=p)
    manifests = [json.loads((tmp_path / side / "step_00000005" / "manifest.json").read_text())
                 for side in ("port", "ref")]
    assert manifests[0] == manifests[1]
    assert list(manifests[0]["leaves"]) == list(manifests[1]["leaves"])  # sorted-key order
    assert manifests[0]["leaves"]["bf"]["dtype"] == "bfloat16"
    keys = [sorted(np.load(tmp_path / side / "step_00000005" / "shard_0.npz").files)
            for side in ("port", "ref")]
    assert keys[0] == keys[1] and "a__w" in keys[0] and "layers__1" in keys[0]


def test_shard_split_equals_the_reference(tmp_path, monkeypatch):
    """With a small shard limit, leaves land in the same shard files on
    both sides (the order of the flattening decides the split)."""
    monkeypatch.setattr(ckpt, "_MAX_SHARD_BYTES", 64)
    monkeypatch.setattr(ref_ckpt, "_MAX_SHARD_BYTES", 64)
    host = _mixed(seed=3)
    save_checkpoint(str(tmp_path / "port"), 1, _as_port(host))
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 1, _as_ref(host))
    manifests = [json.loads((tmp_path / side / "step_00000001" / "manifest.json").read_text())
                 for side in ("port", "ref")]
    assert manifests[0] == manifests[1] and manifests[0]["n_shards"] > 2
    got, _ = restore_checkpoint(str(tmp_path / "ref"), _as_port(host))
    for p, leaf in _paths(got).items():
        np.testing.assert_array_equal(_bits(leaf), _bits(_paths(_as_port(host))[p]), err_msg=p)


def test_async_save_then_in_place_update_cannot_tear(tmp_path):
    """``save`` returns with its host copy complete: an in-place AdamW
    update issued right after it does not reach the checkpoint."""
    params = {"w": torch.linspace(-1, 1, 64).reshape(8, 8).to(torch.bfloat16),
              "b": torch.linspace(0, 1, 8)}
    cfg = AdamWConfig(lr=0.1, warmup_steps=1)
    state = {"params": params, "opt": adamw_init(params, cfg)}
    grads = tree_map(lambda p: torch.ones_like(p), params)
    adamw_update(grads, state["opt"], state["params"], cfg)
    before = tree_map(torch.clone, state)
    ac = AsyncCheckpointer(str(tmp_path), keep=2)
    ac.save(1, state)
    adamw_update(grads, state["opt"], state["params"], cfg)  # in place, at once
    ac.close()
    got, _ = restore_checkpoint(str(tmp_path), state)
    for p, leaf in _paths(got).items():
        np.testing.assert_array_equal(_bits(leaf), _bits(_paths(before)[p]), err_msg=p)
    assert not torch.equal(state["params"]["w"], before["params"]["w"])


@pytest.mark.parametrize("hosts", [list(range(8)), [f"host-{i}" for i in range(6)],
                                   [3, 17, 40]])
def test_elastic_assignment_equals_the_reference(hosts):
    for n in (1, 13, 64):
        assert elastic_shard_assignment(n, hosts) == ref_fault.elastic_shard_assignment(n, hosts)
    fewer = hosts[1:]
    assert elastic_shard_assignment(64, fewer) == ref_fault.elastic_shard_assignment(64, fewer)


@pytest.mark.parametrize("crash_at,max_restarts", [((7, 23), 3), ((4, 5, 6), 2), ((), 3)])
def test_run_with_restart_equals_the_reference(crash_at, max_restarts):
    """Both drivers, fed the same step / save / restore callables, make the
    same calls and return the same state and restart count (or both give up
    with the same calls made)."""
    def drive(driver):
        log, saved, pending = [], {}, list(crash_at)

        def step_fn(state, step):
            log.append(("step", step))
            if pending and step == pending[0]:
                pending.pop(0)
                raise RuntimeError("simulated failure")
            return state + [step]

        def save_fn(state, step):
            log.append(("save", step))
            saved[step] = list(state)

        def restore_fn():
            st = max(saved) if saved else 0
            log.append(("restore", st))
            return list(saved.get(st, [])), st

        try:
            out = driver(step_fn, save_fn, restore_fn, [], n_steps=30, checkpoint_every=5,
                         max_restarts=max_restarts)
        except RuntimeError:
            out = "gave up"
        return out, log

    assert drive(run_with_restart) == drive(ref_fault.run_with_restart)
