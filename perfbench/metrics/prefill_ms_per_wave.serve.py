"""Host milliseconds of one admission (the batched prefill, its merge into
the arena and the first-token sync) in the window: the engine's
``admit_seconds`` over ``prefill_batches``."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    a, b = rec["stats0"]["decode"], rec["stats1"]["decode"]
    n = b["prefill_batches"] - a["prefill_batches"]
    return 1e3 * (b["admit_seconds"] - a["admit_seconds"]) / n if n else None
