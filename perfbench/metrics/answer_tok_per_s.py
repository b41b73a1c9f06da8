"""Generated tokens of every answer finished inside the window, over the
window's seconds (host clock)."""


def read(rec):
    if rec["kind"] != "serve" or not rec["window_s"]:
        return None
    return sum(d["tokens"] for d in rec["finished"]) / rec["window_s"]
