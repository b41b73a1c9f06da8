"""Share of the window's retrieval-cache lookups that hit, from the
engine's own ``cache.hits`` / ``cache.misses`` counters (in %)."""


def read(rec):
    if rec["kind"] != "serve":
        return None
    a, b = rec["stats0"]["cache"], rec["stats1"]["cache"]
    hits, misses = b["hits"] - a["hits"], b["misses"] - a["misses"]
    return 100.0 * hits / (hits + misses) if hits + misses else None
