"""Multi-pod dry run: every (arch x shape x mesh) cell's step on placeholder
devices (the reference's ``repro.launch.dryrun``).

The reference lowers and compiles each cell's step for 512 placeholder XLA
host devices and reads XLA's memory and cost analyses.  The twin starts a
fake process group of 256 (``16x16``) or 512 (``2x16x16``) ranks in this
one process, builds the production mesh over it (``launch.mesh``), makes the
parameters (shapes from the port's own init under ``FakeTensorMode``), the
optimizer state and the inputs (``configs.input_specs(abstract=True)``) as
DTensors over meta-tensor shards placed by the family's policy
(``distributed.policies`` through ``named``), runs the family step once as
rank 0 and counts what rank 0 does with its local shards:

- **FLOPs**: the matmul-family ops of ``torch.utils.flop_counter``'s table,
  counted below the DTensor dispatch (on local shapes, not the global op);
- **bytes**: each local op's tensor inputs read plus its outputs written
  (view ops move nothing);
- **collectives**: the result bytes of each functional collective on the
  local shard, by the reference's kinds; an all-reduce counts twice, as in
  the reference's ``collective_bytes``;
- **memory**: the peak of live meta storages over the step, the arguments
  counted apart (``memory`` keeps the reference's keys, and its
  ``per_device_total`` is that peak).

Nothing is allocated and no card is touched: meta tensors are no CUDA
tensors, so every kernel op takes its plain version, as the reference
traces its XLA paths (it too scores ``retrieval_cand`` with the plain
top-k).  The temporaries counted are therefore the plain versions', not the
hand kernels'.  Ops that DTensor cannot place on these layouts get the dry
run's own rules (``_fallback_ops``: most run replicated, their inputs
all-gathered) and are listed in the record's ``replicated_ops``.  A ``1x1``
mesh (``run_cell(..., mesh_shape=(1, 1))``, one card) runs plain meta
tensors, no DTensor.

**No two-point fit.**  The reference's layers run under ``lax.scan``, whose
body XLA's cost analysis counts once, so it fits X(L) = a + b*L from L = 1
and 2.  The port's layers are a Python loop: every layer's ops are counted.
The analysis run keeps the reference's overrides (remat off, single-tile
attention / loss / edge chunking, one micro-batch), which fix what is
counted, at full depth; its counts are ``fit_per_device`` (no ``points``).
The memory run uses the full config.

The process group is process-global: ``run_cell`` starts it and destroys it
in a ``finally``; importing this module starts nothing.

Usage:
  python -m repro_torch.launch.dryrun --arch wide-deep --shape retrieval_cand
  python -m repro_torch.launch.dryrun --all --both-meshes [--out reports/dryrun_torch]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import weakref

import torch

from repro_torch import configs as C
from repro_torch.distributed import policies as pol
from repro_torch.distributed.constraints import active_mesh, contiguous_stride, shard_hint
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.tree import tree_leaves, tree_map
from repro_torch.training.optimizer import AdamWConfig

_KINDS = {  # DTensor's functional collectives -> the reference's HLO names
    "all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce", "all_to_all_single": "all-to-all",
}
# Backward formulas write into fresh zeros in place in eager mode
# (``zeros(...).index_add_(...)``), but under a Python dispatch mode (fake
# tensors, DTensor, this counter) PyTorch takes their subclass-safe branch,
# ``new_zeros(...).index_add(...)``, which holds a second full-size buffer.
# An op of this table whose destination is the fresh zeros of the op just
# before is counted in place, as the card runs it.
_IN_PLACE_IN_EAGER = {"index_add", "index_copy", "index_put", "scatter", "scatter_add",
                      "masked_scatter", "slice_scatter", "select_scatter",
                      "diagonal_scatter", "as_strided_scatter"}
_ZEROS = {"new_zeros", "zeros", "zeros_like"}
_NO_BYTES = ("empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided")


def _tensors(tree) -> list:
    """The tensors in nested tuples, lists and dicts (an op's arguments or
    results, a step's output)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


class _Uncached(Exception):
    pass


def _meta_key(x):
    """A hashable stand-in for an op's arguments: a meta tensor by its
    shape, strides and dtype; anything else by value."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta" or type(x) is not torch.Tensor:
            raise _Uncached
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_meta_key(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _meta_key(v)) for k, v in sorted(x.items()))
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype, torch.device,
                                   torch.memory_format, torch.layout)):
        return x
    raise _Uncached


def _result_meta(t: torch.Tensor) -> tuple:
    return (tuple(t.shape), t.stride(), t.dtype)


def _empty(meta: tuple) -> torch.Tensor:
    shape, stride, dtype = meta
    return torch.empty_strided(shape, stride, dtype=dtype, device="meta")


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


class _Count:
    """A dispatch mode that sees rank 0's local ops (DTensor ops pass through
    to DTensor, whose local ops come back here) and counts them."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return counter._dispatch(func, types, args, kwargs or {})

        self.mode = Mode()
        self.flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll: dict = {}
        self.live = 0
        self.peak = 0
        self._sizes: dict = {}  # id(storage) -> bytes counted live
        self._fresh = None  # id(storage) of the last op's output if it made zeros
        self._meta: dict = {}  # (op, its arguments' metadata) -> its results' metadata

    # -- memory ----------------------------------------------------------
    def track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key, n = id(st), st.nbytes()
        old = self._sizes.get(key)
        if old is None:
            weakref.finalize(st, self._free, key)
        elif n <= old:
            return
        self._sizes[key] = n
        self.live += n - (old or 0)
        self.peak = max(self.peak, self.live)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    def storage_bytes(self, tensors) -> int:
        seen = {}
        for t in tensors:
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
        return sum(seen.values())

    # -- ops ---------------------------------------------------------------
    def _dispatch(self, func, types, args, kwargs):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it; its local ops come back here
        out = self._run(func, args, kwargs)
        outs = _tensors(out)
        if not outs or outs[0].device.type != "meta":
            # not rank 0's shards: DTensor's index arithmetic (real tensors)
            # or its shape propagation (its own fake tensors)
            return out
        name = func._overloadpacket.__name__
        fresh, self._fresh = self._fresh, None
        if (name in _IN_PLACE_IN_EAGER and isinstance(args[0], torch.Tensor)
                and id(args[0].untyped_storage()) == fresh):
            self.live -= self._sizes.get(fresh, 0)  # the zeros become the result
            self._sizes[fresh] = 0
        for t in outs:
            self.track(t)
        if name in _ZEROS:
            self._fresh = id(outs[0].untyped_storage())
        ns = func.namespace
        if ns.startswith("_c10d_functional"):
            kind = _KINDS.get(name)
            if kind is not None:
                nb = sum(t.nbytes for t in outs) * (2 if kind == "all-reduce" else 1)
                self.coll[kind] = self.coll.get(kind, 0) + nb
            return out
        f = self.flop_registry.get(func._overloadpacket)
        if f is not None:
            self.flops += int(f(*args, **kwargs, out_val=out))
        if not func.is_view and name not in _NO_BYTES:
            self.bytes += sum(t.nbytes for t in _tensors((args, kwargs))) + sum(
                t.nbytes for t in outs)
        return out

    def _run(self, func, args, kwargs):
        """``func`` on meta tensors.  The plain versions' tile loops repeat a
        few ops on the same shapes thousands of times, and PyTorch computes
        most meta results in Python: a functional op (no argument written,
        no result aliasing one) whose arguments' shapes, strides, dtypes
        and values were seen before gets fresh tensors of the results'
        metadata without running (ops without a tensor argument, whose
        device the key cannot see, always run)."""
        schema = func._schema
        if (any(a.alias_info is not None for a in schema.arguments)
                or any(r.alias_info is not None for r in schema.returns)
                or func.namespace != "aten" or not _tensors((args, kwargs))):
            return func(*args, **kwargs)
        try:
            key = (func, _meta_key(args), _meta_key(kwargs))
            hash(key)
        except _Uncached:
            return func(*args, **kwargs)
        spec = self._meta.get(key)
        if spec is None:
            out = func(*args, **kwargs)
            if isinstance(out, torch.Tensor):
                self._meta[key] = (False, _result_meta(out))
            elif isinstance(out, tuple) and out and all(isinstance(t, torch.Tensor)
                                                         for t in out):
                self._meta[key] = (True, tuple(_result_meta(t) for t in out))
            return out
        many, meta = spec
        return tuple(_empty(m) for m in meta) if many else _empty(meta)

    def collectives(self) -> dict:
        out = dict(self.coll)
        out["total"] = sum(out.values())
        return out


def _replicated(op_call, args, kwargs):
    """An op with no DTensor sharding rule for these layouts, run as an SPMD
    program lowers it: every DTensor input but an in-place op's destination
    all-gathered (replicated); an in-place op then applies the whole update
    to rank 0's own shard of the destination (the rows it owns; on meta
    tensors the indices are not checked), an out-of-place op runs on the
    full tensors and its result is replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._pytree import tree_map as pmap

    mesh = next(a.device_mesh for a in _tensors((args, kwargs)) if isinstance(a, DTensor))
    _REPLICATED[str(op_call)] = _REPLICATED.get(str(op_call), 0) + 1
    full = lambda x: (x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()  # noqa: E731
                      if isinstance(x, DTensor) else x)
    if op_call._schema.arguments[0].is_write:  # in place: args[0] is the destination
        dst = args[0]
        op_call(_local(dst), *pmap(full, args[1:]), **pmap(full, kwargs))
        return dst
    out = op_call(*pmap(full, args), **pmap(full, kwargs))
    return pmap(lambda t: DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
                if isinstance(t, torch.Tensor) else t, out)


_REPLICATED: dict = {}
_ORIGINAL: dict = {}  # DTensor's own handlers of the ops the dry run handles, while it runs


def _by_default(op_call, args, kwargs):
    """``op_call`` through DTensor's own rules (the dry run's handler set
    aside, DTensor's own handler, if it has one, back in place)."""
    handlers = _handlers()
    mine = handlers.pop(op_call)
    if _ORIGINAL.get(op_call) is not None:
        handlers[op_call] = _ORIGINAL[op_call]
    try:
        return op_call(*args, **kwargs)
    finally:
        handlers[op_call] = mine


def _view(op_call, args, kwargs):
    """A view DTensor cannot propagate: one that splits a dim sharded
    unevenly into its new dims (24 heads over 16 ranks; GSPMD pads there),
    or a strided layout DTensor's view rules fail on.  The input's mesh dims
    are replicated one at a time, last first, until the view goes through
    (the reference's layout after its padding is not modelled)."""
    from torch.distributed.tensor import Replicate

    x = args[0]
    while True:
        try:
            return _by_default(op_call, (x,) + tuple(args[1:]), kwargs)
        except (RuntimeError, NotImplementedError):
            sharded = [i for i, p in enumerate(x.placements) if not p.is_replicate()]
            if not sharded:
                raise
        placements = list(x.placements)
        placements[sharded[-1]] = Replicate()
        _REPLICATED[str(op_call)] = _REPLICATED.get(str(op_call), 0) + 1
        x = x.redistribute(x.device_mesh, placements)


def _gather(op_call, args, kwargs):
    """``torch.gather``: DTensor's masked-partial rule for it (which it
    picks even for an input replicated along the gathered dim) fails to
    reduce on fake tensors.  The input's mesh dims that shard the gathered
    dim (or hold partial sums) are replicated, the index takes the input's
    placements, and the gather runs on the local shards."""
    from torch.distributed.tensor import DTensor, Replicate

    x, dim, idx = args[0], args[1] % args[0].ndim, args[2]
    mesh = x.device_mesh
    placements = [Replicate() if p.is_shard(dim) or p.is_partial() else p
                  for p in x.placements]
    if placements != list(x.placements):
        _REPLICATED[str(op_call)] = _REPLICATED.get(str(op_call), 0) + 1
        x = x.redistribute(mesh, placements)
    idx = idx.redistribute(mesh, placements)
    out = op_call(x.to_local(), dim, idx.to_local(), *args[3:], **kwargs)
    return DTensor.from_local(out, mesh, placements, run_check=False, shape=idx.shape,
                              stride=idx.stride())


def _argmax(op_call, args, kwargs):
    """``argmax`` / ``argmin`` along a dim: DTensor's own handler gathers the
    local winners with a shape that breaks for a batch of one.  The reduced
    dim (and any partial sum) is replicated first, the op runs on the local
    shard, and the result keeps the input's other shards."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    x = args[0]
    dim = args[1] if len(args) > 1 else kwargs.get("dim")
    keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    if dim is None:
        return _by_default(op_call, args, kwargs)
    dim %= x.ndim
    mesh = x.device_mesh
    placements = [Replicate() if p.is_shard(dim) or p.is_partial() else p
                  for p in x.placements]
    if placements != list(x.placements):
        _REPLICATED[str(op_call)] = _REPLICATED.get(str(op_call), 0) + 1
        x = x.redistribute(mesh, placements)
    out = op_call(x.to_local(), dim, keepdim)
    shape = list(x.shape)
    if keepdim:
        shape[dim] = 1
    else:
        del shape[dim]
        placements = [Shard(p.dim - 1) if p.is_shard() and p.dim > dim else p
                      for p in placements]
    return DTensor.from_local(out, mesh, placements, run_check=False, shape=tuple(shape),
                              stride=contiguous_stride(shape))


def _local_attention(fn):
    """``fn`` (the port's dense or chunked attention over (B, S, heads, dh))
    run on local shards, as GSPMD partitions attention: batch rows over the
    DP axes (where they divide) and query heads over "model" (unevenly
    where they do not divide: rank 0 holds the first ceil(H / n)), with the
    KV heads replicated and rank 0 keeping the ones its query heads read.
    Without this, DTensor would dispatch every op of the plain flash
    version's tile loops."""
    def run(q, k, v, *args, **kwargs):
        from torch.distributed.tensor import DTensor, Replicate, Shard

        if not isinstance(q, DTensor):
            return fn(q, k, v, *args, **kwargs)
        mesh = q.device_mesh
        names = tuple(mesh.mesh_dim_names)
        dp = [i for i, n in enumerate(names) if n in ("pod", "data")]
        dp_size = 1
        for i in dp:
            dp_size *= mesh.size(i)
        rows = [Shard(0) if i in dp and q.shape[0] % dp_size == 0 else Replicate()
                for i in range(mesh.ndim)]
        heads = [Shard(2) if names[i] == "model" and mesh.size(i) > 1 else p
                 for i, p in enumerate(rows)]
        rep = q.shape[2] // k.shape[2]
        q = q.redistribute(mesh, heads)
        k, v = (t.redistribute(mesh, rows) for t in (k, v))
        ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
        h = ql.shape[2]
        if h < k.shape[2] * rep:  # rank 0's query heads read the first KV heads
            kv = h // rep if h % rep == 0 else 1
            kl, vl = kl[:, :, :kv], vl[:, :, :kv]
        o = fn(ql, kl, vl, *args, **kwargs)
        return DTensor.from_local(o, mesh, heads, run_check=False, shape=q.shape,
                                  stride=q.stride())
    return run


# the port's attention over whole sequences (``models.transformer.attention``),
# run on local shards (above)
_ATTENTION = ("dense_attention", "chunked_attention")


class _ChunkRows:
    """A row-sharded edge array (``Shard(0)`` over the DP axes) read chunk
    by chunk, as EquiformerV2's loops read it (``g.src[span]``): chunk ``ci``
    is a DTensor of the chunk's global shape whose rank-0 piece is the
    ``ci``-th of rank 0's own rows cut in ``len(spans)`` equal parts, so each
    device scans its own edges a chunk at a time.  Slicing the sharded array
    instead would all-gather all of it for every chunk (DTensor's rule for
    a partial slice of a sharded dim)."""

    def __init__(self, x, spans: list):
        self.x, self.chunk = x, spans[0].stop - spans[0].start
        self.local = x.to_local()
        self.rows = self.local.shape[0] // len(spans)

    def __getitem__(self, span: slice):
        from torch.distributed.tensor import DTensor

        ci = span.start // self.chunk
        piece = self.local[ci * self.rows:(ci + 1) * self.rows]
        shape = (self.chunk,) + tuple(self.x.shape[1:])
        return DTensor.from_local(piece, self.x.device_mesh, self.x.placements, run_check=False,
                                  shape=shape, stride=contiguous_stride(shape))


def _chunked_edges(make):
    """``equiformer._Edges`` with its row-sharded edge arrays read chunk by
    chunk (``_ChunkRows``) where the rows split evenly into the chunks."""
    def build(**kw):
        from torch.distributed.tensor import DTensor

        spans = kw["spans"]
        for name in ("src", "dst", "emask", "ebin", "rbf"):
            x = kw[name]
            if (isinstance(x, DTensor) and any(p.is_shard(0) for p in x.placements)
                    and all(p.is_shard(0) or p.is_replicate() for p in x.placements)
                    and x.to_local().shape[0] % len(spans) == 0):
                kw[name] = _ChunkRows(x, spans)
        return make(**kw)
    return build


def _handlers() -> dict:
    from torch.distributed.tensor import DTensor

    return DTensor._op_dispatcher._custom_op_handlers


def _fallback_ops() -> dict:
    """Ops the port's steps run that DTensor has no sharding rule for (or
    whose rule cannot keep an in-place destination's placement): they run
    through ``_replicated``."""
    aten = torch.ops.aten
    return {aten.index_put_.default: _replicated, aten.scatter_reduce.two: _replicated,
            aten.view.default: _view, aten._unsafe_view.default: _view,
            aten.gather.default: _gather, aten.argmax.default: _argmax,
            aten.argmin.default: _argmax}


@contextlib.contextmanager
def _fake_world(world: int, rank: int = 0):
    """A fake process group of ``world`` ranks, this process rank ``rank``;
    destroyed on the way out, whatever happens inside."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _counting(count: _Count, mesh):
    """Rank 0's local ops counted; on a mesh of several ranks, with
    ``_fallback_ops`` handled by the dry run's rules, whole-sequence
    attention run on local shards and EquiformerV2's edge arrays read chunk
    by chunk from each rank's own rows (``_chunked_edges``)."""
    if mesh.size() == 1:  # no DTensor: the arguments are plain local tensors
        with count.mode:
            yield count
        return
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.gnn import equiformer
    from repro_torch.models.transformer import attention

    fallback = _fallback_ops()
    handlers = _handlers()
    _ORIGINAL.update({op: handlers.get(op) for op in fallback})
    whole = {name: getattr(attention, name) for name in _ATTENTION}
    for name, fn in whole.items():
        setattr(attention, name, _local_attention(fn))
    make_edges = equiformer._Edges
    equiformer._Edges = _chunked_edges(make_edges)
    handlers.update(fallback)
    try:
        with implicit_replication(), count.mode:
            yield count
    finally:
        for name, fn in whole.items():
            setattr(attention, name, fn)
        equiformer._Edges = make_edges
        for op, fn in _ORIGINAL.items():
            if fn is None:
                handlers.pop(op, None)
            else:
                handlers[op] = fn
        _ORIGINAL.clear()


# ---------------------------------------------------------------------------
# placement: shape-dtype trees to DTensors on the mesh
# ---------------------------------------------------------------------------
def place(tree, specs, mesh):
    """Every leaf of ``tree`` (anything with ``shape`` and ``dtype``) as a
    DTensor on ``mesh`` placed by the matching entry of ``specs`` (a
    placement tuple, ``policies``' form), whose local tensor is rank 0's
    shard, fresh (its storage holds the shard alone)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    def one(x, spec):
        placements = pol.named(mesh, spec)
        shape = tuple(x.shape)
        local_shape, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
        local = torch.empty(local_shape, dtype=x.dtype, device="meta")
        return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                                  stride=contiguous_stride(shape))

    return tree_map(one, tree, specs)


def _fake_init(fn):
    """``fn()``'s parameter tree under ``FakeTensorMode``: the port's own
    init, shapes and dtypes only."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return fn()


def param_shapes(spec, cfg):
    """The port's init of ``cfg`` under fake mode (the twin of the
    reference's ``jax.eval_shape`` of its init)."""
    gen = torch.Generator()
    if spec.family == "lm":
        from repro_torch.models.transformer import model as tm

        return _fake_init(lambda: tm.init_params(cfg, gen, device="cpu"))
    if spec.family == "gnn":
        from repro_torch.models.gnn import init_gnn

        return _fake_init(lambda: init_gnn(cfg, gen, device="cpu"))
    from repro_torch.models.recsys import wide_deep

    return _fake_init(lambda: wide_deep.init_wide_deep(cfg, gen, device="cpu"))


def _opt_cfg(spec) -> AdamWConfig:
    big = spec.family == "lm" and spec.model_cfg.param_count()[0] > 50e9
    return AdamWConfig(state_dtype="bfloat16" if big else "float32")


def _state_specs(psp) -> dict:
    return {"params": psp, "opt": {"m": psp, "v": psp, "step": ()}}


def _state_shapes(params, opt_cfg: AdamWConfig) -> dict:
    from repro_torch.training.optimizer import _STATE_DTYPES

    dt = _STATE_DTYPES[opt_cfg.state_dtype]
    like = lambda t: torch.empty(t.shape, dtype=dt, device="meta")  # noqa: E731
    return {"params": params, "opt": {"m": tree_map(like, params), "v": tree_map(like, params),
                                      "step": torch.empty((), dtype=torch.int32,
                                                          device="meta")}}


# ---------------------------------------------------------------------------
# per-family steps: (fn, args (shape trees), specs (placement trees), donated)
# ---------------------------------------------------------------------------
def build_lm(spec, shape, mesh, cfg, *, n_micro=None):
    from repro_torch.configs.common import lm_inputs
    from repro_torch.models.transformer import model as tm
    from repro_torch.training import make_train_step

    ms = pol.MeshShape.of(mesh)
    inputs = lm_inputs(shape, cfg, abstract=True)
    params = param_shapes(spec, cfg)
    psp = pol.lm_param_specs(params, moe_mode=cfg.moe.shard_mode if cfg.moe else "expert")
    dp = pol.dp_axes(ms)

    if shape.kind == "train":
        opt_cfg = _opt_cfg(spec)

        def loss_fn(p, batch):
            # each micro-batch back on the DP axes (slicing the batch dim
            # gathered it): the reference's per-(device, micro-batch) rows
            return tm.lm_loss(p, shard_hint(batch["tokens"], "dp", None),
                              shard_hint(batch["loss_mask"], "dp", None), cfg)

        if n_micro is None:
            n_micro = int(os.environ.get("REPRO_N_MICRO", "8"))
        _, step = make_train_step(loss_fn, opt_cfg, n_microbatches=n_micro)
        args = (_state_shapes(params, opt_cfg), inputs)
        specs = (_state_specs(psp), {"tokens": pol._spec(dp, None),
                                     "loss_mask": pol._spec(dp, None)})
        return step, args, specs, (0,)

    if shape.kind == "prefill":
        cache_len = shape.params["seq_len"]
        b = pol.batch_axes_or_none(ms, shape.params["global_batch"])

        def fn(p, tokens, true_len):
            return tm.prefill(p, tokens, true_len, cfg, cache_len)

        return (fn, (params, inputs["tokens"], inputs["true_len"]),
                (psp, pol._spec(b, None), pol._spec(b)), ())

    # decode / long_decode
    batch = shape.params["global_batch"]
    cs = pol.lm_cache_specs(ms, batch, cfg.n_kv_heads,
                            kv_shard=os.environ.get("REPRO_KV_SHARD", "seq"))
    b = pol.batch_axes_or_none(ms, batch)

    def fn(p, ck, cv, cpos, cursor, token, ks=None, vs=None):
        cache = tm.KVCache(k=ck, v=cv, pos=cpos, cursor=cursor, k_scale=ks, v_scale=vs)
        nxt, cache = tm.decode_step(p, cache, token, cfg)
        return torch.argmax(nxt, -1).to(torch.int32), cache

    args = [params, inputs["cache_k"], inputs["cache_v"], inputs["cache_pos"],
            inputs["cursor"], inputs["token"]]
    specs = [psp, cs["k"], cs["v"], cs["pos"], cs["cursor"], pol._spec(b)]
    donated = (1, 2)
    if cfg.kv_quant:
        args += [inputs["k_scale"], inputs["v_scale"]]
        specs += [cs["k"][:-1], cs["k"][:-1]]
        donated = (1, 2, 6, 7)
    return fn, tuple(args), tuple(specs), donated


def build_gnn(spec, shape, mesh, cfg, *, edge_chunk=16384):
    from repro_torch.configs.common import gnn_inputs
    from repro_torch.models.gnn import gnn_loss
    from repro_torch.models.gnn.common import segment_sum
    from repro_torch.training import make_train_step

    inputs = gnn_inputs(shape, cfg, abstract=True)
    params = param_shapes(spec, cfg)

    def loss_fn(p, batch):
        if cfg.arch == "equiformer_v2":
            from repro_torch.models.gnn.equiformer import apply_equiformer

            out = apply_equiformer(p, cfg, batch, edge_chunk=edge_chunk)
            tgt = batch["targets"]
            if cfg.graph_readout and "graph_ids" in batch:
                out = segment_sum(out, batch["graph_ids"], tgt.shape[0])
            return torch.mean((out - tgt) ** 2), {}
        return gnn_loss(p, cfg, batch), {}

    opt_cfg = AdamWConfig()
    _, step = make_train_step(loss_fn, opt_cfg)
    psp = pol.gnn_param_specs(params)
    in_specs = pol.gnn_input_specs(pol.MeshShape.of(mesh), inputs.keys())
    return step, (_state_shapes(params, opt_cfg), inputs), (_state_specs(psp), in_specs), (0,)


def build_recsys(spec, shape, mesh, cfg):
    from repro_torch.configs.common import recsys_inputs
    from repro_torch.models.recsys import wide_deep
    from repro_torch.training import make_train_step

    inputs = recsys_inputs(shape, cfg, abstract=True)
    rs = pol.recsys_input_specs(pol.MeshShape.of(mesh))
    if shape.kind == "retrieval":
        from repro_torch.kernels.topk_sim import ref as topk_ref

        def fn(query, cand):
            return topk_ref.topk_similarity(query, cand, shape.params["k"])

        return fn, (inputs["query"], inputs["cand_emb"]), (rs["query"], rs["cand_emb"]), ()

    params = param_shapes(spec, cfg)
    psp = pol.recsys_param_specs(params)
    if shape.kind == "train":
        def loss_fn(p, batch):
            return wide_deep.wide_deep_loss(p, cfg, batch["dense"], batch["sparse_ids"],
                                            batch["labels"]), {}

        opt_cfg = AdamWConfig()
        _, step = make_train_step(loss_fn, opt_cfg)
        b_specs = {k: rs[k] for k in inputs}
        return (step, (_state_shapes(params, opt_cfg), inputs), (_state_specs(psp), b_specs),
                (0,))

    def fn(p, dense, sparse_ids):
        return wide_deep.wide_deep_logits(p, cfg, dense, sparse_ids)

    return (fn, (params, inputs["dense"], inputs["sparse_ids"]),
            (psp, rs["dense"], rs["sparse_ids"]), ())


# ---------------------------------------------------------------------------
def _analysis_cfg(spec, shape):
    """The counting variant: no remat and single-tile attention / loss
    chunking, so no recomputation and no tile loop changes what is counted
    (the reference's overrides, at full depth)."""
    cfg = C.effective_model_cfg(spec, shape)
    if spec.family == "lm":
        s = shape.params.get("seq_len", 4096)
        return dataclasses.replace(cfg, q_chunk=max(s, 256), kv_chunk=max(s, 256),
                                   loss_chunk=max(s - 1, 1), remat=False, scan_layers=False)
    return cfg


def _run_step(spec, shape, mesh, cfg, *, edge_chunk=16384, n_micro=None) -> dict:
    """Place the cell's arguments on ``mesh``, run its step once as rank 0
    and count it."""
    builder = {"lm": build_lm, "gnn": build_gnn, "recsys": build_recsys}[spec.family]
    kw = {"edge_chunk": edge_chunk} if spec.family == "gnn" else (
        {"n_micro": n_micro} if spec.family == "lm" else {})
    _REPLICATED.clear()
    fn, args, specs, donated = builder(spec, shape, mesh, cfg, **kw)
    if mesh.size() == 1:  # every placement is the whole tensor
        placed = tuple(tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), a)
                       for a in args)
    else:
        placed = tuple(place(a, s, mesh) for a, s in zip(args, specs))
    count = _Count()
    arg_locals = [_local(t) for t in tree_leaves(placed) if isinstance(t, torch.Tensor)]
    for t in arg_locals:
        count.track(t)
    arg_bytes = count.live
    with active_mesh(mesh) if mesh.size() > 1 else contextlib.nullcontext(), \
            _counting(count, mesh):
        out = fn(*placed)
    out_locals = [_local(t) for t in _tensors(_out_tree(out))]
    arg_ids = {id(t.untyped_storage()) for t in arg_locals}
    output_bytes = count.storage_bytes(out_locals)
    alias_bytes = count.storage_bytes(
        [t for t in out_locals if id(t.untyped_storage()) in arg_ids])
    temp = max(count.peak - arg_bytes - (output_bytes - alias_bytes), 0)
    return {
        "memory": {"argument_bytes": arg_bytes, "output_bytes": output_bytes,
                   "temp_bytes": temp, "alias_bytes": alias_bytes,
                   "per_device_total": arg_bytes + temp + output_bytes - alias_bytes},
        "flops": count.flops, "bytes": count.bytes, "collectives": count.collectives(),
        "replicated_ops": dict(_REPLICATED), "donated": list(donated),
    }


def _out_tree(out):
    """A step's result as a tree of tensors (a ``KVCache`` by its fields)."""
    if dataclasses.is_dataclass(out):
        return [getattr(out, f.name) for f in dataclasses.fields(out)]
    if isinstance(out, (tuple, list)):
        return [_out_tree(o) for o in out]
    if isinstance(out, dict):
        return {k: _out_tree(v) for k, v in out.items()}
    return out


def run_cell(arch_id: str, shape_name: str, *, multi_pod: bool = False,
             skip_analysis: bool = False, edge_chunk: int = 16384,
             mesh_shape: tuple | None = None) -> dict:
    """One cell's record (the reference's keys).  ``mesh_shape`` replaces
    the production mesh by ``(data, model)`` sizes (``(1, 1)``: one card)."""
    spec = C.get_config(arch_id)
    shape = spec.shapes[shape_name]
    mesh_name = ("x".join(map(str, mesh_shape)) if mesh_shape
                 else "2x16x16" if multi_pod else "16x16")
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name, "kind": shape.kind}
    if shape.kind == "skip":
        rec["status"] = "skip"
        rec["reason"] = shape.params["reason"]
        return rec
    n_dev = 1
    for s in mesh_shape or ((2, 16, 16) if multi_pod else (16, 16)):
        n_dev *= s
    t0 = time.time()
    with _fake_world(n_dev):
        mesh = (make_mesh(mesh_shape, ("data", "model")) if mesh_shape
                else make_production_mesh(multi_pod=multi_pod))
        cfg_full = C.effective_model_cfg(spec, shape)
        if os.environ.get("REPRO_KV_QUANT") == "1" and spec.family == "lm":
            cfg_full = dataclasses.replace(cfg_full, kv_quant=True)
        full = _run_step(spec, shape, mesh, cfg_full, edge_chunk=edge_chunk)
        rec["memory"] = full["memory"]
        rec["cost_full_program"] = {"flops": float(full["flops"]), "bytes": float(full["bytes"])}
        rec["collectives_full_program"] = full["collectives"]
        rec["replicated_ops"] = full["replicated_ops"]
        rec["compile_s_full"] = round(time.time() - t0, 1)
        if not skip_analysis and spec.family in ("lm", "gnn"):
            from repro_torch.configs.common import padded_edges

            cfg_a = _analysis_cfg(spec, shape)
            if os.environ.get("REPRO_KV_QUANT") == "1" and spec.family == "lm":
                cfg_a = dataclasses.replace(cfg_a, kv_quant=True)
            ana = _run_step(spec, shape, mesh, cfg_a, n_micro=1,
                            edge_chunk=padded_edges(shape) if spec.family == "gnn" else 16384)
            rec["fit_per_device"] = {"flops": float(ana["flops"]),
                                     "hbm_bytes": float(ana["bytes"]),
                                     "collective_bytes": ana["collectives"]["total"],
                                     "n_layers": cfg_full.n_layers}
        elif spec.family == "recsys":
            rec["fit_per_device"] = {"flops": rec["cost_full_program"]["flops"],
                                     "hbm_bytes": rec["cost_full_program"]["bytes"],
                                     "collective_bytes": rec["collectives_full_program"]["total"]}
    rec["n_devices"] = n_dev
    rec["status"] = "ok"
    rec["compile_s_total"] = round(time.time() - t0, 1)
    return rec


def all_cells():
    for arch_id in C.ARCH_IDS:
        for shape_name in C.get_config(arch_id).shapes:
            yield arch_id, shape_name


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-analysis", action="store_true",
                    help="the full-config run only (no counting run)")
    ap.add_argument("--out", default="reports/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    cells = list(all_cells()) if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    os.makedirs(args.out, exist_ok=True)
    for arch_id, shape_name in cells:
        for mp in meshes:
            tag = f"{arch_id}__{shape_name}__{'mp' if mp else 'sp'}"
            path = os.path.join(args.out, tag + ".json")
            if os.path.exists(path) and not args.force:
                print(f"[cached] {tag}")
                continue
            print(f"[run] {tag}", flush=True)
            try:
                rec = run_cell(arch_id, shape_name, multi_pod=mp,
                               skip_analysis=args.skip_analysis or mp)
            except Exception as e:  # record failures: they are bugs to fix
                rec = {"arch": arch_id, "shape": shape_name,
                       "mesh": "2x16x16" if mp else "16x16",
                       "status": "error", "error": f"{type(e).__name__}: {e}"}
                print(f"  ERROR {rec['error'][:300]}", flush=True)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            if rec.get("status") == "ok":
                mem = rec["memory"]["per_device_total"] / 2**30
                print(f"  ok mem/dev={mem:.2f} GiB compile={rec['compile_s_total']}s", flush=True)


if __name__ == "__main__":
    main()
