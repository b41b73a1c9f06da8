"""A run whose timed path is broken underneath comes out not correct.

Each fault is planted in the program (at the call the window drives) and
the rest of the run, the check with the cell's own limits included, is
driven as on the card: a step that leaves its state unchanged, half of
the batch left out, and a token or an answer altered where it is made.
(No cell spans two cards, so no exchange between cards can be left out.)
"""
from __future__ import annotations

import dataclasses

import pytest
import torch
from conftest import ROOT, tiny

from perfbench.lib import spec

S = spec.Spec(ROOT)
SERVE = [c["name"] for c in S.data["workloads"] if S.traffic(c)["kind"] == "rag_serve_closed_loop"]
RETRIEVE = [c["name"] for c in S.data["workloads"] if S.traffic(c)["kind"] == "retrieve_batches"]


def _token_altered(mp):
    from repro_torch.models.transformer import model as tm

    orig = tm.serve_step
    mp.setattr(tm, "serve_step", lambda p, c, t, cfg: (lambda o: ((o[0] + 1) % cfg.vocab, o[1]))(
        orig(p, c, t, cfg)))


def _state_unchanged(mp):
    from repro_torch.models.transformer import model as tm

    orig = tm.decode_step

    def step(params, cache, token, cfg):
        copy = dataclasses.replace(cache, k=cache.k.clone(), v=cache.v.clone(),
                                   pos=cache.pos.clone(), cursor=cache.cursor.clone())
        return orig(params, copy, token, cfg)[0], cache  # the arena never moves

    mp.setattr(tm, "decode_step", step)


def _half_batch(mp):
    from repro_torch.models.transformer import model as tm

    orig = tm.serve_step

    def step(params, cache, token, cfg):
        nxt, cache = orig(params, cache, token, cfg)
        half = token.shape[0] // 2
        return torch.cat([nxt[:half], token[half:]]), cache  # the second half left out

    mp.setattr(tm, "serve_step", step)


def _answer_altered(mp):
    from repro_torch.core import filters

    orig = filters.dynamic_filter

    def filt(sub, scores, seeds, *, budget):
        out = orig(sub, scores, seeds, budget=budget)
        bumped = torch.where(out.mask, (out.nodes + 1) % out.num_nodes, out.nodes)
        return dataclasses.replace(out, nodes=bumped.to(out.nodes.dtype))

    mp.setattr(filters, "dynamic_filter", filt)


def _hop_unchanged(mp):
    from repro_torch.kernels.bfs_frontier import ops

    mp.setattr(ops, "frontier_hop", lambda frontier, nbr, mask, **kw: frontier.clone())


def _half_queries(mp):
    from repro_torch.core.pipeline import RGLPipeline

    orig = RGLPipeline.retrieve

    def retrieve(self, q, encoder=None):
        res = orig(self, q, encoder=encoder)
        h = res.nodes.shape[0] // 2
        if h == 0:
            return res
        idx = torch.arange(res.nodes.shape[0], device=res.nodes.device) % h
        sub = dataclasses.replace(res.sub, nodes=res.sub.nodes[idx], mask=res.sub.mask[idx],
                                  dist=res.sub.dist[idx])
        return dataclasses.replace(res, sub=sub, seeds=res.seeds[idx])

    mp.setattr(RGLPipeline, "retrieve", retrieve)


SERVE_FAULTS = {"token_altered": _token_altered, "state_unchanged": _state_unchanged,
                "half_batch_left_out": _half_batch, "answer_altered": _answer_altered}
RETRIEVE_FAULTS = {"answer_altered": _answer_altered, "state_unchanged": _hop_unchanged,
                   "half_batch_left_out": _half_queries}


@pytest.mark.parametrize("fault", list(SERVE_FAULTS))
@pytest.mark.parametrize("workload", SERVE)
def test_serve_fault_is_not_correct(workload, fault, run_tiny, monkeypatch):
    over = tiny(workload)
    over["traffic"].update(check_requests=8, max_new_tokens=6)  # every slot's answers checked
    assert run_tiny(workload, over=over)["correct"] is True
    SERVE_FAULTS[fault](monkeypatch)
    out = run_tiny(workload, over=over)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("fault", list(RETRIEVE_FAULTS))
@pytest.mark.parametrize("workload", RETRIEVE)
def test_retrieve_fault_is_not_correct(workload, fault, run_tiny, monkeypatch):
    assert run_tiny(workload)["correct"] is True
    RETRIEVE_FAULTS[fault](monkeypatch)
    out = run_tiny(workload)
    assert out["correct"] is False
    assert out["checks"]["retrieval_mismatches"]["value"] > 0
