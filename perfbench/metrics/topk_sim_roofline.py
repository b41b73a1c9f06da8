"""``topk_sim``'s share of its roofline over the traced window, in %: the
least time the H100 could take for each call (``counts/topk_sim.py`` at
the call's shapes: the batch's Q queries against all N embeddings, float32
on the CUDA cores at 67 TFLOP/s, or 3.35 TB/s) times the calls, over the
device time of the scan and merge kernels.  One call is one merge
launch."""
from perfbench.counts import topk_sim
from perfbench.lib import peaks


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "retrieve" or not t or not t["n_device_events"]:
        return None
    secs = sum(v for k, v in t["device_ops"].items()
               if "topk_sim_scan_kernel" in k or "topk_merge_kernel" in k)
    calls = sum(v for k, v in t["launches"].items() if "topk_merge_kernel" in k)
    if not calls or not secs:
        return None
    q, n, d, k = rec["batch"], rec["n_nodes"], rec["dim"], rec["k_seeds"]
    least = peaks.roofline_s(topk_sim.flops(q, n, d, k), topk_sim.bytes_moved(q, n, d, k),
                             peaks.FP32_FLOPS)
    return 100.0 * calls * least / secs
