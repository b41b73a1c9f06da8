"""Median host milliseconds of one batch in the window, from the call into
the pipeline to its ids on the host."""


def read(rec):
    if rec["kind"] != "retrieve" or rec["median_batch_s"] is None:
        return None
    return 1e3 * rec["median_batch_s"]
