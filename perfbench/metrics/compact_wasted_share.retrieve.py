"""Share of the retrievals' device time spent in compact passes that
``auto`` threw away for a dense re-run, in %: the device time of the
program's ``rgl.retrieve.subgraph.compact`` spans, times the share of them
that a ``rgl.retrieve.subgraph.rerun`` followed, over the device time of
its ``rgl.retrieve`` spans (``trace["spans"]``).  Exact when every batch
or none re-runs.  None where the trace carries no spans."""


def read(rec):
    sp = (rec.get("trace") or {}).get("spans") or {}
    compact, total = sp.get("rgl.retrieve.subgraph.compact"), sp.get("rgl.retrieve")
    if rec["kind"] != "retrieve" or not compact or not compact["count"] or not total \
            or not total["device_s"]:
        return None
    reruns = sp.get("rgl.retrieve.subgraph.rerun", {"count": 0})["count"]
    return 100.0 * compact["device_s"] * reruns / compact["count"] / total["device_s"]
