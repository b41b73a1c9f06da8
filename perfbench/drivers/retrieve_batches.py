"""Back-to-back batched retrieval (traffic kind ``retrieve_batches``).

One caller sends batches of ``batch`` queries (the embeddings of query
nodes drawn from the seed) through the program's ``RGLPipeline.retrieve``
(index -> seeds -> subgraph -> filter) and brings each batch's seeds and
filtered node ids to the host before sending the next.  No language
model is built.

The check holds a sample of the window's queries, drawn from the seed, to
the plain NumPy reference: seeds and filtered nodes, near-ties aside.
"""
from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from perfbench.lib import stack as st
from perfbench.lib import trace as tr
from perfbench.lib.queries import query_sampler
from perfbench.reference import retrieval as ref_ret


class Driver:
    def __init__(self, cfg: dict, traffic: dict, device: torch.device, cache_dir):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.corpus = st.load_corpus(cfg, cache_dir)
        self.pipe = st.pipeline(cfg, self.corpus, device, with_tokenizer=False)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _batch(self, ids: np.ndarray) -> dict:
        with tr.span("retrieve"):
            res = self.pipe.retrieve(self.corpus["feat"][ids])
        with tr.span("to_host"):
            nodes, mask, seeds = res.nodes.cpu(), res.mask.cpu(), res.seeds.cpu()
        return {"nodes": nodes.numpy(), "mask": mask.numpy(), "seeds": seeds.numpy(),
                "dense_rerun": res.overflow is None}

    def run(self, seed: int, seconds: float, trace: bool) -> dict:
        t = self.traffic
        n = self.corpus["feat"].shape[0]
        draw = query_sampler(np.random.default_rng(seed), n, t)
        for _ in range(t["warmup_batches"]):
            self._batch(draw(t["batch"]))
        self._sync()
        now = time.perf_counter
        batches = []
        tracer = tr.Tracer(self.device) if trace else None
        if tracer:
            tracer.warm()
        t0, t0_wall = now(), time.time()
        while now() - t0 < seconds:
            if tracer and tracer.prof is None and now() - t0 >= seconds - t["trace_seconds"]:
                tracer.start()
            ids = draw(t["batch"])
            b0 = now()
            out = self._batch(ids)
            out.update(ids=ids, wall_s=now() - b0)
            batches.append(out)
        self._sync()
        t1 = now()
        summary = None
        if tracer:
            summary = tracer.finish(lambda: self._batch(draw(t["batch"])), t["trace_seconds"])
        walls = [b["wall_s"] for b in batches]
        print(f"batches in the window: {len(batches)} of {t['batch']} queries, in {t1 - t0:.3f} s",
              file=sys.stderr, flush=True)
        return {"kind": "retrieve", "window_s": t1 - t0, "window_start": t0_wall,
                "batches": batches, "trace": summary, "queries": t["batch"] * len(batches),
                "attempted": t["batch"] * len(batches), "failed": 0, "batch": t["batch"],
                "n_nodes": n, "arcs": int(self.corpus["indices"].shape[0]),
                "dim": int(self.corpus["feat"].shape[1]),
                "k_seeds": self.cfg["retriever"]["k_seeds"],
                "median_batch_s": statistics.median(walls) if walls else None,
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                                      if self.device.type == "cuda" else 0)}

    def check(self, rec: dict, seed: int, limits: dict, control: bool = False) -> dict:
        rc = self.cfg["retriever"]
        feat = self.corpus["feat"]
        emb_n = ref_ret.normalize(feat)
        pairs = [(bi, qi) for bi, b in enumerate(rec["batches"]) for qi in range(len(b["ids"]))]
        rng = np.random.default_rng([seed, 1])
        k = min(len(pairs), self.traffic["check_queries"])
        pick = rng.choice(len(pairs), size=k, replace=False) if k else []
        bad, tie, ctl_bad = 0, 0.0, 0
        for p in sorted(pick):
            bi, qi = pairs[p]
            b = rec["batches"][bi]
            q = feat[b["ids"][qi]]
            got = b["nodes"][qi][b["mask"][qi]]
            c = ref_ret.compare(emb_n, self.corpus["indptr"], self.corpus["indices"], q, rc, got,
                                got_seeds=b["seeds"][qi])
            bad += c["mismatch"]
            tie = max(tie, c["tie_gap"])
            if control:
                r = ref_ret.retrieve(emb_n, self.corpus["indptr"], self.corpus["indices"], q, rc,
                                     dtype="bfloat16")
                ctl_bad += ref_ret.compare(emb_n, self.corpus["indptr"], self.corpus["indices"], q,
                                           rc, r["nodes"], got_seeds=r["seeds"])["mismatch"]
        checks = {"retrieval_mismatches": {"value": bad, "limit": limits["retrieval_mismatches"]}}
        info = {"queries_checked": int(k), "retrieval_tie_gap": tie}
        if control:
            info["control_retrieval_mismatches"] = ctl_bad
        return {"correct": bool(k > 0 and bad <= limits["retrieval_mismatches"]), "checks": checks,
                "info": info}
