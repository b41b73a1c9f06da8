"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, traffic kind's driver, limit file and metric is found by
name, the file keeps the contract's shape, and a new cell, configuration,
traffic mix, traffic kind or metric is added by adding files and entries
alone."""
from __future__ import annotations

import json
import re
import shutil

import pytest
from conftest import ROOT, tiny

from perfbench.lib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
S = spec.Spec(ROOT)


def test_every_cell_finds_its_files():
    for cell in S.data["workloads"]:
        assert S.config(cell)["name"] == cell["config"]
        drv = S.driver(S.traffic(cell)["kind"])
        assert callable(drv.run) and callable(drv.check)
        assert S.limits(cell)
        assert cell["chips"] == 1


@pytest.mark.parametrize("metric", [m["name"] for m in S.data["end_to_end"] + S.data["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(S.reader(metric))


def test_contract_shape():
    d = S.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert d["paths"] == ["perfbench"] and d["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= d["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in d[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in d["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
    e2e = {m["name"]: m for m in d["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in d["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in d["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {m["layer"] for m in d["per_layer"]}
    assert all(0 < len(x) <= 200 for x in layers)
    for cell in d["workloads"]:
        got = [m["name"] for m in S.metrics(cell, trace=False)]
        assert "setup_s" in got and len(got) >= 2
        per = S.metrics(cell, trace=True)
        assert per
        for m in per:  # the metric it moves is reported in the cell
            assert m["moves"] in got
    assert len(json.dumps(d)) < 64 * 1024


def test_a_cell_config_traffic_and_metric_added_as_files(tmp_path, run_tiny):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell
    with its limits and a per-layer metric, as new files and new entries
    only; a run of the new cell reads the new metric."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src").symlink_to(ROOT / "src")
    d = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = root / "perfbench"
    cfg = json.loads((pb / "configs" / "starcoder2-3b.json").read_text())
    cfg["name"] = "starcoder2-3b-ivf"
    cfg["retriever"]["index"] = "ivf"
    (pb / "configs" / "starcoder2-3b-ivf.json").write_text(json.dumps(cfg))
    d["configs"].append(dict(d["configs"][0], name="starcoder2-3b-ivf",
                             file="perfbench/configs/starcoder2-3b-ivf.json"))
    traffic = json.loads((pb / "traffic" / "retrieve_uniform_q256.json").read_text())
    traffic["batch"] = 64
    (pb / "traffic" / "retrieve_uniform_q64.json").write_text(json.dumps(traffic))
    name = "retrieve.starcoder2-3b-ivf.q64"
    d["workloads"].append({"name": name, "config": "starcoder2-3b-ivf",
                           "traffic": "retrieve_uniform_q64", "chips": 1, "why": "a test cell"})
    (pb / "limits" / f"{name}.json").write_text(json.dumps({"retrieval_mismatches": 64}))
    (pb / "metrics" / "batches_seen.retrieve.py").write_text(
        "def read(rec):\n    return float(len(rec['batches'])) if rec['kind'] == 'retrieve' "
        "else None\n")
    d["per_layer"].append({"name": "batches_seen.retrieve", "unit": "batches", "better": "higher",
                           "source": "host_clock", "layer": "retrieval",
                           "moves": "retrieval_queries_per_s", "workloads": [name]})
    for m in d["end_to_end"]:
        if m["name"] == "retrieval_queries_per_s":
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(d))
    over = tiny("retrieve.starcoder2-3b.q256")
    over["traffic"]["batch"] = 8
    out = run_tiny(name, seconds=0.5, trace=True, root=root, over=over)
    assert out["metrics"]["batches_seen.retrieve"]["value"] > 0
    assert out["checks"]["retrieval_mismatches"]["limit"] == 64
    # nothing of the benchmark's own files changed
    for f in (ROOT / "perfbench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            assert (pb / f.relative_to(ROOT / "perfbench")).read_bytes() == f.read_bytes()


NEW_KIND = '''"""Back-to-back batches of index searches alone (a test's traffic kind)."""
import time

import numpy as np

from perfbench.lib import stack as st
from perfbench.lib.queries import query_sampler
from perfbench.reference import retrieval as ref_ret


class Driver:
    def __init__(self, cfg, traffic, device, cache_dir):
        self.cfg, self.traffic = cfg, traffic
        self.corpus = st.load_corpus(cfg, cache_dir)
        self.pipe = st.pipeline(cfg, self.corpus, device, with_tokenizer=False)

    def run(self, seed, seconds, trace):
        t, k = self.traffic, self.cfg["retriever"]["k_seeds"]
        draw = query_sampler(np.random.default_rng(seed), self.corpus["feat"].shape[0], t)
        searches = []
        t0, t0_wall = time.perf_counter(), time.time()
        while time.perf_counter() - t0 < seconds:
            ids = draw(t["batch"])
            _, got = self.pipe.index.search(self.corpus["feat"][ids], k)
            searches.append((ids, got.cpu().numpy()))
        n = t["batch"] * len(searches)
        return {"kind": "index_search", "window_s": time.perf_counter() - t0,
                "window_start": t0_wall, "searches": searches, "attempted": n, "failed": 0,
                "memory_peak_bytes": 0, "trace": None}

    def check(self, rec, seed, limits, control=False):
        emb_n = ref_ret.normalize(self.corpus["feat"])
        k = self.cfg["retriever"]["k_seeds"]
        bad = sum(int(set(ref_ret.top_ids(ref_ret.scores(emb_n, self.corpus["feat"][v]), k))
                      != set(row.tolist()))
                  for ids, got in rec["searches"][:2] for v, row in zip(ids, got))
        checks = {"search_mismatches": {"value": bad, "limit": limits["search_mismatches"]}}
        return {"correct": bad <= limits["search_mismatches"], "checks": checks, "info": {}}
'''


def test_a_traffic_kind_added_as_files(tmp_path, run_tiny):
    """A copy of the benchmark gains a traffic kind (its driver file), a mix
    of that kind, a cell with its limits and the cell's metrics, as new
    files and new entries only; the harness finds the driver by the kind's
    name and a run of the new cell is measured and checked."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src").symlink_to(ROOT / "src")
    d = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = root / "perfbench"
    (pb / "drivers" / "index_search.py").write_text(NEW_KIND)
    (pb / "traffic" / "index_uniform_q8.json").write_text(
        json.dumps({"kind": "index_search", "batch": 8, "query_dist": "uniform"}))
    name = "index.starcoder2-3b.q8"
    d["workloads"].append({"name": name, "config": "starcoder2-3b",
                           "traffic": "index_uniform_q8", "chips": 1, "why": "a test cell"})
    (pb / "limits" / f"{name}.json").write_text(json.dumps({"search_mismatches": 0}))
    (pb / "metrics" / "searches_per_s.py").write_text(
        "def read(rec):\n    return rec['attempted'] / rec['window_s'] "
        "if rec['kind'] == 'index_search' else None\n")
    (pb / "metrics" / "searches_seen.index.py").write_text(
        "def read(rec):\n    return float(len(rec['searches'])) "
        "if rec['kind'] == 'index_search' else None\n")
    d["end_to_end"].insert(0, {"name": "searches_per_s", "unit": "queries/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock", "workloads": [name]})
    d["per_layer"].append({"name": "searches_seen.index", "unit": "batches", "better": "higher",
                           "source": "host_clock", "layer": "retrieval",
                           "moves": "searches_per_s", "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(d))
    over = {"config": {"corpus": {"nodes": 3000}}}
    for trace in (False, True):
        out = run_tiny(name, seconds=0.3, trace=trace, root=root, over=over)
        assert out["correct"] is True and out["attempted"] > 0
        want = "searches_seen.index" if trace else "searches_per_s"
        assert out["metrics"][want]["value"] > 0
        assert out["checks"]["search_mismatches"] == {"value": 0, "limit": 0}
    for f in (ROOT / "perfbench").rglob("*"):
        if f.is_file() and "__pycache__" not in f.parts:
            assert (pb / f.relative_to(ROOT / "perfbench")).read_bytes() == f.read_bytes()
