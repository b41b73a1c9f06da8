"""Device milliseconds of one retrieval batch in the traced window: the
device time of the operations launched inside the program's
``rgl.retrieve`` spans (``trace["spans"]``) over their count.  None where
the trace carries no spans."""


def read(rec):
    sp = (rec.get("trace") or {}).get("spans") or {}
    s = sp.get("rgl.retrieve")
    if rec["kind"] != "serve" or not s or not s["count"]:
        return None
    return 1e3 * s["device_s"] / s["count"]
