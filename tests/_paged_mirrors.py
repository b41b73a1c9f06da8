"""Shared check of the paged-KV tests: a serving engine's host mirrors of
the block allocator equal its device state."""


def assert_mirrors(eng) -> None:
    """The free stack's contents, the refcounts and every slot's table
    prefix on the host equal the engine's ``PagedKVCache``."""
    depth = len(eng._free_stack)
    assert int(eng.cache.n_free) == depth
    assert eng.cache.free[:depth].tolist() == eng._free_stack
    assert eng.cache.ref.tolist() == eng._ref_host.tolist()
    table = eng.cache.table.cpu().numpy()
    for i, blks in enumerate(eng._slot_blocks):
        assert table[i, :len(blks)].tolist() == blks
        assert (table[i, len(blks):] == -1).all()
