"""``bfs_frontier``'s share of its roofline over the traced window, in %:
the least time the H100 could take for each hop (``counts/bfs_frontier.py``
at the batch's Q queries over the corpus's N nodes and E arcs, at 3.35
TB/s) times the hops, over the device time of the pack and hop kernels.
One hop is one ``frontier_hop_*`` launch."""
from perfbench.counts import bfs_frontier
from perfbench.lib import peaks


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "retrieve" or not t or not t["n_device_events"]:
        return None
    secs = sum(v for k, v in t["device_ops"].items()
               if "frontier_hop_" in k or "pack_frontier_kernel" in k)
    hops = sum(v for k, v in t["launches"].items() if "frontier_hop_" in k)
    if not hops or not secs:
        return None
    q, n, e = rec["batch"], rec["n_nodes"], rec["arcs"]
    least = peaks.roofline_s(bfs_frontier.flops(q, n, e), bfs_frontier.bytes_moved(q, n, e),
                             peaks.FP32_FLOPS)
    return 100.0 * hops * least / secs
