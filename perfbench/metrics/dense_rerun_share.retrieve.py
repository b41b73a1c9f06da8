"""Share of the window's batches in which a query overflowed the compact
workset, so that ``auto`` ran the dense backend again (the program's
result then carries no ``overflow`` flags), in %."""


def read(rec):
    if rec["kind"] != "retrieve" or not rec["batches"]:
        return None
    return 100.0 * sum(b["dense_rerun"] for b in rec["batches"]) / len(rec["batches"])
