"""95th percentile (nearest rank) of finish minus submit over every request
finished inside the window, both on the benchmark's clock; a failed
request counts as infinitely late."""
import math


def read(rec):
    if rec["kind"] != "serve" or not rec["finished"]:
        return None
    lat = sorted(math.inf if d["failed"] else d["finish"] - d["submit"] for d in rec["finished"])
    v = lat[math.ceil(0.95 * len(lat)) - 1]
    return None if math.isinf(v) else 1e3 * v
