"""The whole retrieval batch's share of the H100's float32 peak over the
window, in %: each batch's scoring FLOPs (the index scan, 2 Q N D, and the
filter's relevance scores, 2 Q N D more; the graph hops do no arithmetic
to speak of) times the batches, over the window's seconds and 67 TFLOP/s
(float32 outside the tensor cores: the path keeps TF32 off)."""
from perfbench.counts import topk_sim
from perfbench.lib import peaks


def read(rec):
    if rec["kind"] != "retrieve" or not rec["batches"]:
        return None
    q, n, d, k = rec["batch"], rec["n_nodes"], rec["dim"], rec["k_seeds"]
    per = 2 * topk_sim.flops(q, n, d, k)
    return 100.0 * len(rec["batches"]) * per / rec["window_s"] / peaks.FP32_FLOPS
