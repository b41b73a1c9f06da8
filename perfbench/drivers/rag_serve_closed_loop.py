"""Closed-loop RAG serving (traffic kind ``rag_serve_closed_loop``).

``clients`` clients each send a request (a query node's embedding and the
first ``query_words`` words of its text, ``max_new_tokens`` greedy tokens)
and send the next one as soon as the answer comes back.  Query nodes are
drawn from the seed: Zipf(``zipf_s``) over a seeded permutation of the
node ids, so popular questions repeat.  The program's ``RAGServeEngine``
serves them over ``slots`` decode slots, with the cell's retrieval-cache
size, admission and schedule, and a KV arena of the longest prompt the
tokenizer makes plus ``max_new_tokens`` positions a slot; every other
knob is the program's default.

Set-up builds the stack, makes the weights on the device from the seed,
and brings the loop to its steady state: clients start ``slots /
max_new_tokens`` a step until the slots are full, so that as many answers
finish in every step, the rest then start at once and queue, and the
loop runs until the first of them has waited out the queue.  Every shape
the window uses (the padded retrieval wave, the
prefill bucket, the decode step) has run by then.  The window then steps
the engine for ``seconds``.

The check (after the window, with the engine freed) takes a sample of the
answers finished in the window, drawn from the seed, and holds each to
the plain references: its retrieval (seeds and filtered nodes), its
prompt, and every served token's logit against the float32 reference
decoder's best at its position.
"""
from __future__ import annotations

import gc
import math
import sys
import time

import numpy as np
import torch

from perfbench.lib import stack as st
from perfbench.lib import trace as tr
from perfbench.lib import weights
from perfbench.lib.queries import gap_stats, query_sampler
from perfbench.reference import lm as ref_lm
from perfbench.reference import retrieval as ref_ret
from perfbench.reference import tokenizer as ref_tok


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class Driver:
    """The stack, built once; ``run`` serves one seed."""

    def __init__(self, cfg: dict, traffic: dict, device: torch.device, cache_dir):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        t = time.perf_counter()
        self.corpus = st.load_corpus(cfg, cache_dir)
        self.pipe = st.pipeline(cfg, self.corpus, device)
        _log(f"set-up: corpus and pipeline {time.perf_counter() - t:.1f} s")
        self.dims = st.model_dims(cfg)
        if self.pipe.tokenizer.vocab.size > self.dims["vocab"]:
            raise SystemExit(f"the graph tokenizer's {self.pipe.tokenizer.vocab.size} ids do not "
                             f"fit the model's {self.dims['vocab']} embedding rows")
        self.tcfg = st.transformer_config(self.dims)
        words = traffic["query_words"]
        self.query_text = lambda v: " ".join(self.corpus["texts"][v].split()[:words])

    def engine(self, params):
        from repro_torch.serving import RAGServeEngine, ServingConfig

        t = self.traffic
        rc = self.cfg["retriever"]
        # the arena holds what a request can fill: the longest prompt the
        # tokenizer makes and the answer's tokens
        cache_len = rc["max_len"] + t["max_new_tokens"] + 1
        conf = ServingConfig.resolve(None, slots=t["slots"], cache_len=cache_len,
                                     cache_capacity=t["cache_capacity"], admission=t["admission"],
                                     prefetch=t["prefetch"], paged_kv=False, prefix_share=False,
                                     spec_decode=False)
        return RAGServeEngine(self.pipe, params, self.tcfg, config=conf, device=self.device)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, seed: int, seconds: float, trace: bool) -> dict:
        from repro_torch.serving import RAGRequest

        t = self.traffic
        feat = self.corpus["feat"]
        draw = query_sampler(np.random.default_rng(seed), feat.shape[0], t)
        params = weights.make_params(self.dims, seed, self.device)
        eng = self.engine(params)
        now = time.perf_counter
        live: dict = {}  # uid -> (client, node, submit time)
        uid = [0]

        def submit(client: int):
            v = int(draw(1)[0])
            eng.submit(RAGRequest(uid=uid[0], query_emb=feat[v], query_text=self.query_text(v),
                                  max_new_tokens=t["max_new_tokens"]))
            live[uid[0]] = (client, v, now())
            uid[0] += 1

        def step(done):
            """One engine step; answers finished in it go to ``done`` (the
            window's list, None in set-up) and their clients send again."""
            with tr.span("engine_step"):
                out = eng.step()
            end = now()
            for r in out:
                client, v, t_sub = live.pop(r.uid)
                ok = r.done and not (r.failed or r.shed)
                if done is not None:
                    done.append({"uid": r.uid, "node": v, "submit": t_sub, "finish": end,
                                 "tokens": len(r.out_tokens) if ok else 0, "failed": not ok,
                                 "prompt": None if r.prompt_ids is None else r.prompt_ids.tolist(),
                                 "nodes": None if r.retrieved_nodes is None
                                 else r.retrieved_nodes.tolist(),
                                 "out": list(map(int, r.out_tokens))})
                with tr.span("client_submit"):
                    submit(client)

        # set-up: clients start slots / max_new a step until the slots are
        # full, so that as many answers finish in every step; then the rest
        # start at once and queue, and the loop runs until the first of
        # them has waited out the queue and been answered
        per_step = math.ceil(t["slots"] / t["max_new_tokens"])
        fill = math.ceil(min(t["clients"], t["slots"]) / per_step)
        queue = math.ceil(max(0, t["clients"] - t["slots"]) / per_step)
        warm = fill + queue + t["max_new_tokens"] + t["settle_steps"]
        t_warm = now()
        for s in range(warm):
            if s < fill:
                for c in range(s * per_step, min(t["slots"], t["clients"], (s + 1) * per_step)):
                    submit(c)
            elif s == fill:
                for c in range(t["slots"], t["clients"]):
                    submit(c)
            step(None)
        self._sync()
        _log(f"set-up: {warm} warm-up steps {now() - t_warm:.1f} s")
        stats0 = eng.stats_ns()
        done: list = []
        tracer = tr.Tracer(self.device) if trace else None
        if tracer:
            tracer.warm()
        t0, t0_wall = now(), time.time()
        while now() - t0 < seconds:
            if tracer and tracer.prof is None and now() - t0 >= seconds - t["trace_seconds"]:
                tracer.start()  # the window's last trace_seconds
            step(done)
        self._sync()
        t1 = now()
        stats1 = eng.stats_ns()
        summary = tracer.finish(lambda: step(None), t["trace_seconds"]) if tracer else None
        rec = {"kind": "serve", "window_s": t1 - t0, "window_start": t0_wall, "finished": done,
               "stats0": stats0, "stats1": stats1, "dims": self.dims, "trace": summary,
               "attempted": len(done), "failed": sum(1 for d in done if d["failed"]),
               "memory_peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                                     if self.device.type == "cuda" else 0)}
        _log(f"answers finished in the window: {len(done)} (the p95 is over these), "
             f"in {rec['window_s']:.3f} s")
        del eng
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        rec["params"] = params
        return rec

    # -- the check ------------------------------------------------------------
    def sample(self, rec: dict, seed: int) -> list:
        """The answers to check: the longest finished in the window, then
        others drawn from the seed, ``check_requests`` in all."""
        ok = [d for d in rec["finished"] if not d["failed"]]
        if not ok:
            return []
        longest = max(range(len(ok)), key=lambda i: (len(ok[i]["prompt"]) + len(ok[i]["out"]), -i))
        rest = [i for i in range(len(ok)) if i != longest]
        rng = np.random.default_rng([seed, 1])
        k = min(len(rest), self.traffic["check_requests"] - 1)
        pick = [longest] + sorted(rng.choice(rest, size=k, replace=False).tolist())
        return [ok[i] for i in pick]

    def check(self, rec: dict, seed: int, limits: dict, control: bool = False) -> dict:
        rc = self.cfg["retriever"]
        feat = self.corpus["feat"]
        emb_n = ref_ret.normalize(feat)
        vocab = ref_tok.build_vocab(self.corpus["texts"])
        chosen = self.sample(rec, seed)
        ret_bad = prompt_bad = short = 0
        tie = 0.0
        seqs = []
        for d in chosen:
            c = ref_ret.compare(emb_n, self.corpus["indptr"], self.corpus["indices"],
                                feat[d["node"]], rc, d["nodes"] or [])
            tie = max(tie, c["tie_gap"])
            ret_bad += c["mismatch"]
            want = ref_tok.linearize(vocab, self.query_text(d["node"]),
                                     [self.corpus["texts"][v] for v in (d["nodes"] or [])],
                                     rc["max_len"], rc["node_budget"])
            prompt_bad += want != d["prompt"]
            short += len(d["out"]) != self.traffic["max_new_tokens"]
            out = [x if 0 <= x < self.dims["vocab"] else 0 for x in d["out"]]
            seqs.append((want, out))
        params = rec.pop("params")
        gaps = ref_lm.served_gaps(params, self.dims, seqs, quant="fp8" if control else None)
        numbers = {"retrieval_mismatches": ret_bad, "prompt_mismatches": prompt_bad,
                   "short_answers": short}
        numbers.update(gap_stats("served_logit_gap", [x for g in gaps for x in g["served"]]))
        # the numbers the cell's limits name are compared; the rest are shown
        checks = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
        correct = bool(chosen) and all(c["value"] == c["value"] and c["value"] <= c["limit"]
                                       for c in checks.values())
        info = {"answers_checked": len(chosen),
                "served_tokens_checked": sum(len(g["served"]) for g in gaps),
                "retrieval_tie_gap": tie}
        altered = [x for g in gaps for x in g["altered"]]
        if altered:  # what one altered token adds to the mean over the sample
            info["altered_token_gap_mean"] = sum(altered) / len(altered)
        info.update({k: v for k, v in numbers.items() if k not in checks})
        if control:
            info.update(gap_stats("control_logit_gap", [x for g in gaps for x in g["control"]]))
            bad = 0
            for d in chosen:
                r = ref_ret.retrieve(emb_n, self.corpus["indptr"], self.corpus["indices"],
                                     feat[d["node"]], rc, dtype="bfloat16")
                bad += ref_ret.compare(emb_n, self.corpus["indptr"], self.corpus["indices"],
                                       feat[d["node"]], rc, r["nodes"])["mismatch"]
            info["control_retrieval_mismatches"] = bad
        return {"correct": bool(correct), "checks": checks, "info": info}
