"""Queries whose seeds and filtered node ids reached the host inside the
window, over the window's seconds (host clock)."""


def read(rec):
    if rec["kind"] != "retrieve" or not rec["window_s"]:
        return None
    return rec["queries"] / rec["window_s"]
