"""Seeded query draws and the summaries of a comparison's gaps, shared by
the traffic drivers."""
from __future__ import annotations

import math

import numpy as np


def query_sampler(rng: np.random.Generator, n: int, traffic: dict):
    """draw(k) -> k query node ids: uniform, or Zipf(``zipf_s``) over a
    seeded permutation of the node ids."""
    if traffic["query_dist"] == "uniform":
        return lambda k: rng.integers(0, n, size=k)
    perm = rng.permutation(n)
    w = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** traffic["zipf_s"]
    cdf = np.cumsum(w)
    cdf /= cdf[-1]
    return lambda k: perm[np.minimum(np.searchsorted(cdf, rng.random(k), side="right"), n - 1)]


def gap_stats(name: str, gaps: list) -> dict:
    """The widest gap, the mean and the 99th percentile (nearest rank)."""
    if not gaps:
        return {name: float("nan"), name + "_mean": float("nan"), name + "_p99": float("nan")}
    g = sorted(gaps)
    return {name: g[-1], name + "_mean": sum(g) / len(g),
            name + "_p99": g[math.ceil(0.99 * len(g)) - 1]}
