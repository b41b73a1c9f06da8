"""Share of the window's retrieval batches in which a query overflowed the
compact workset, so that ``auto`` threw the compact pass away and ran the
dense backend again, in %: the window's change of the pipeline's
``retrieval.dense_reruns`` over that of ``retrieval.batches`` (as
``dense_rerun_share.retrieve`` reads it in the retrieve cell; where every
batch runs the compact pass, as in the serve cells, this is the share of
``retrieval.compact_runs`` re-run).  None where the program keeps no such
counters."""


def read(rec):
    if rec["kind"] != "serve" or "retrieval" not in rec["stats1"]:
        return None
    a, b = rec["stats0"]["retrieval"], rec["stats1"]["retrieval"]
    n = b["batches"] - a["batches"]
    return 100.0 * (b["dense_reruns"] - a["dense_reruns"]) / n if n else None
