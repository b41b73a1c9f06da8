"""Share of the retrieval rows in the window that held a real query, in %:
the window's change of the pipeline's ``retrieval.valid_rows`` over that of
``retrieval.rows`` (a wave is padded to a fixed row count).  None where
the program keeps no such counters."""


def read(rec):
    if rec["kind"] != "serve" or "retrieval" not in rec["stats1"]:
        return None
    a, b = rec["stats0"]["retrieval"], rec["stats1"]["retrieval"]
    rows = b["rows"] - a["rows"]
    return 100.0 * (b["valid_rows"] - a["valid_rows"]) / rows if rows else None
