"""Share of the decode steps' host time in which no operation ran on the
device, in %: the idle time inside the program's ``rgl.decode.step`` spans
over their wall time (``trace["spans"]``).  None where the trace carries
no spans."""


def read(rec):
    sp = (rec.get("trace") or {}).get("spans") or {}
    s = sp.get("rgl.decode.step")
    if rec["kind"] != "serve" or not s or not s["wall_s"]:
        return None
    return 100.0 * s["idle_s"] / s["wall_s"]
