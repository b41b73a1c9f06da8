"""One pull-BFS hop (``bfs_frontier``) for Q queries over a graph of N
nodes and E arcs: a node is reached when any neighbour is in the frontier.

What these inputs need: the (Q, N) frontier read once (one byte a node and
query), each real arc's neighbour id read once (4 bytes; the ELL padding
is not needed), and the (Q, N) reach written once.  Operations are one
test per arc and query, which never bounds it."""
from __future__ import annotations


def flops(q: int, n: int, e: int) -> float:
    return float(q) * e


def bytes_moved(q: int, n: int, e: int) -> float:
    return 2.0 * q * n + 4.0 * e
