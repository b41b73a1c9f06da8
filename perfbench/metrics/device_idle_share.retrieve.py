"""Share of the traced window in which no operation ran on the device:
1 - (union of the device events' intervals) / (the traced window), from
``torch.profiler`` (in %)."""


def read(rec):
    t = rec.get("trace")
    if rec["kind"] != "retrieve" or not t or not t["n_device_events"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
