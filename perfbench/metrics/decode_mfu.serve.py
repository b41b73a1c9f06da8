"""Model FLOPs of the tokens decoded in the window (the engine's
``decode_tokens``: live slots only), over the window's seconds and the
H100's published bf16 peak (989 TFLOP/s), in %.  A decoded token costs
the matrices it passes through plus attention over its context, whose
mean is taken from the answers finished in the window (prompt plus the
tokens before it)."""
from perfbench.counts import transformer as tf
from perfbench.lib import peaks


def read(rec):
    if rec["kind"] != "serve" or not rec["finished"]:
        return None
    a, b = rec["stats0"]["decode"], rec["stats1"]["decode"]
    tokens = b["decode_tokens"] - a["decode_tokens"]
    ok = [d for d in rec["finished"] if not d["failed"] and d["prompt"]]
    if not tokens or not ok:
        return None
    # the j-th decoded token (j >= 1) of an answer attends to prompt + j + 1 positions
    ctx = [len(d["prompt"]) + j + 1 for d in ok for j in range(1, len(d["out"]))]
    dims = rec["dims"]
    per = tf.matmul_flops_per_token(dims) + tf.attention_flops(dims, sum(ctx) / len(ctx))
    return 100.0 * tokens * per / rec["window_s"] / peaks.BF16_FLOPS
