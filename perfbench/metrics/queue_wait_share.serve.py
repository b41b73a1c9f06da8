"""Share of the served requests' time from submit to answer spent before
their prefill started (the pending queue, the retrieval wave and the
admission queue), in %: the window's change of the engine's
``requests.queue_seconds`` over that of ``requests.latency_seconds``.
None where the program keeps no such counters."""


def read(rec):
    if rec["kind"] != "serve" or "requests" not in rec["stats1"]:
        return None
    a, b = rec["stats0"]["requests"], rec["stats1"]["requests"]
    lat = b["latency_seconds"] - a["latency_seconds"]
    return 100.0 * (b["queue_seconds"] - a["queue_seconds"]) / lat if lat > 0 else None
