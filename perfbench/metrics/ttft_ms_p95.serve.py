"""95th percentile (nearest rank) of the time to first token (submit to the
first token on the host, on the engine's clock) of the requests served in
the window, in ms: the engine keeps each served request's time in
``requests.ttft_s``, newest last, and the window's are the last
``requests.finished`` of ``stats1`` less that of ``stats0``.  None where
the program keeps no such times, or kept fewer than the window served."""
import math


def read(rec):
    if rec["kind"] != "serve" or "ttft_s" not in rec["stats1"].get("requests", {}):
        return None
    a, b = rec["stats0"]["requests"], rec["stats1"]["requests"]
    n = b["finished"] - a["finished"]
    if not 0 < n <= len(b["ttft_s"]):
        return None
    ttft = sorted(b["ttft_s"][-n:])
    return 1e3 * ttft[math.ceil(0.95 * n) - 1]
