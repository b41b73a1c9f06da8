"""Host milliseconds of one decode step in the window (the engine's
``decode_seconds`` over ``decode_steps``; the step's token sync
included)."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    a, b = rec["stats0"]["decode"], rec["stats1"]["decode"]
    n = b["decode_steps"] - a["decode_steps"]
    return 1e3 * (b["decode_seconds"] - a["decode_seconds"]) / n if n else None
