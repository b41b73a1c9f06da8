"""Device milliseconds of subgraph construction a retrieval batch in the
traced window: the device time of the operations launched inside the
program's ``rgl.retrieve.subgraph`` spans over the count of its
``rgl.retrieve`` spans (``trace["spans"]``).  None where the trace
carries no spans."""


def read(rec):
    sp = (rec.get("trace") or {}).get("spans") or {}
    sub, total = sp.get("rgl.retrieve.subgraph"), sp.get("rgl.retrieve")
    if rec["kind"] != "retrieve" or not sub or not total or not total["count"]:
        return None
    return 1e3 * sub["device_s"] / total["count"]
