"""Host milliseconds of one admission retrieval wave in the window: the
engine's ``retrieval_seconds`` (launch plus collect) over its
``retrieval_batches``."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    a, b = rec["stats0"]["engine"], rec["stats1"]["engine"]
    n = b["retrieval_batches"] - a["retrieval_batches"]
    return 1e3 * (b["retrieval_seconds"] - a["retrieval_seconds"]) / n if n else None
