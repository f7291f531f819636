"""Static cost analysis: one rank's FLOPs, HBM bytes, collective bytes and
memory, counted op by op on ``meta`` tensors.  Counterpart of
``repro/distribution/hlo_analysis.py``, which reads them from XLA's
partitioned HLO; the port has no HLO, so ``CostCounter`` (a
``TorchDispatchMode``) counts the aten ops a step runs instead, and the
kernels' ``meta`` routes book their launches (``kernels.cost``).

What is counted, per op that reaches the counter:
  * flops            -- matmul-class ops by ``torch.utils.flop_counter``'s
                        formulas (mm, bmm, addmm, baddbmm, convolutions);
                        elementwise arithmetic counts none (the reference
                        counts 1 per element: ROADMAP queue C).  A booked
                        kernel adds its ``kernels.cost`` FLOPs.
  * bytes            -- operands read plus results written.  Views,
                        ``expand``, ``_unsafe_view``, ``empty*`` and
                        ``detach`` move nothing; fills (``zeros_like``,
                        ``new_zeros``, ``fill_``, ...) only write; an expanded
                        operand is read once; ``copy_`` reads its source and writes its
                        destination (a slice of a cache: the region); gathers
                        (``embedding``, ``index``, ``index_select``,
                        ``gather``) read the rows they fetch, and in-place
                        scatters (``index_copy_``, ``index_put_``, ...) read
                        and write the rows they update, as the reference's
                        rules for gather, scatter and dynamic-update-slice.
                        A booked kernel adds its ``kernels.cost`` bytes.
  * collective_bytes -- per kind, the operand bytes of each collective
                        (functional or c10d), as the reference sums them.
  * kernel_bytes     -- 0 by construction: a booked kernel has no interior
                        here.  Kept so that artifacts keep the reference's
                        schema.

Per rank under DTensor: a DTensor op makes the counter return
``NotImplemented``, so DTensor's own dispatch runs with the counter still
active, and its redistributions, collectives and local op reach the
counter as plain tensors of this rank's shards.  Every count is then the
explicit local computation of the rank the process plays (rank 0 of a fake
process group in the dry-run).  The global-shape shape inference that
DTensor's sharding propagator runs on fake tensors is not counted.

Data-dependent shapes: a ``meta`` tensor has no values, so a boolean mask
(the expert-parallel MoE's kept slots, ``moe_ep._local_moe``) is taken as
all true while the counter is active: its gathers and scatters are counted
for every routed slot, an upper bound (the expert FFN runs on the
capacity-sized buffer either way).

Meta outputs: a meta kernel runs in Python and checks its shapes
symbolically (~150 us for a binary elementwise op in torch 2.13), and a
loop over time (xLSTM's sLSTM) repeats the same ops on the same shapes
tens of thousands of times.  The counter keeps, per
op and input signature (shapes, strides, dtypes and every non-tensor
argument), the metadata of the outputs a functional op gave on ``meta``
tensors, and makes fresh empty tensors with it when the signature comes
again.  Views, in-place and ``out=`` ops, collectives and ops whose output
shape depends on values always run their kernel.

Memory: ``track_arguments`` records the argument tensors (parameters,
optimizer state, batch or cache); every other storage a counted op makes
adds its bytes to the live total when it is made and takes them off when
it is freed, so saved activations stay live as on the card; ``temp_bytes``
is the peak of that total.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

from ..kernels import cost
from . import sharding

__all__ = ["COLLECTIVES", "Totals", "CostCounter", "local_bytes"]

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
)

#: functional and c10d collective op names -> the reference's collective kinds
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced":
    "reduce-scatter", "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all", "broadcast": "collective-permute",
    "broadcast_": "collective-permute", "send": "collective-permute",
    "recv_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d", "c10d_functional")

_aten = torch.ops.aten
#: ops that move nothing although their schema does not say they alias
_NO_BYTES = {
    _aten._unsafe_view.default, _aten.empty.memory_format, _aten.empty_strided.default,
    _aten.empty_like.default, _aten.new_empty.default, _aten.new_empty_strided.default,
    _aten.detach.default, _aten.lift_fresh.default,
}
#: gathers: read the fetched rows, write them, read the indices (position
#: of the indices among the arguments)
_GATHERS = {
    _aten.embedding.default: 1, _aten.index.Tensor: 1, _aten.index_select.default: 2,
    _aten.gather.default: 2,
}
#: in-place scatters: read and write the updated rows, read the indices
#: (positions of the updates and of the indices among the arguments)
_SCATTERS = {
    _aten.index_copy_.default: (3, 2), _aten.index_put_.default: (2, 1),
    _aten._index_put_impl_.default: (2, 1), _aten.index_add_.default: (3, 2),
    _aten.scatter_.src: (3, 2), _aten.scatter_add_.default: (3, 2),
    _aten.scatter_reduce_.two: (3, 2),
}
#: ops that write their result and read nothing (an operand gives only its
#: dtype, device or the region to fill)
_WRITE_ONLY = {
    _aten.fill_.Scalar, _aten.fill_.Tensor, _aten.zero_.default, _aten.new_zeros.default,
    _aten.new_ones.default, _aten.new_full.default, _aten.zeros_like.default,
    _aten.ones_like.default, _aten.full_like.default,
}


_ALIASING: Dict[Any, bool] = {}


def _returns_alias(func) -> bool:
    """Whether the op's schema says a result aliases an input."""
    hit = _ALIASING.get(func)
    if hit is None:
        hit = _ALIASING[func] = any(r.alias_info is not None for r in func._schema.returns)
    return hit


_MEMOIZABLE: Dict[Any, bool] = {}
_VALUE_TAGS = tuple(getattr(torch.Tag, t) for t in (
    "dynamic_output_shape", "data_dependent_output", "nondeterministic_seeded")
    if hasattr(torch.Tag, t))


class _Meta(NamedTuple):
    """A tensor output's metadata, kept for ``CostCounter._run``."""

    shape: tuple
    stride: tuple
    dtype: torch.dtype


def _memoizable(func) -> bool:
    """Whether an op's outputs are fresh tensors whose metadata its inputs'
    metadata fixes: an aten op that is no view, aliases and mutates
    nothing, and has no value-dependent output."""
    hit = _MEMOIZABLE.get(func)
    if hit is None:
        hit = _MEMOIZABLE[func] = (
            func.namespace == "aten" and not func.is_view and not _returns_alias(func)
            and not func._schema.is_mutable and not any(t in func.tags for t in _VALUE_TAGS))
    return hit


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes of ``t`` as an operand: an expanded (stride 0) dim is read once."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st != 0) * t.element_size()


def _tensors(x) -> list:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def local_bytes(tree: Any) -> int:
    """Bytes of this rank's part of every tensor in ``tree`` (a DTensor's
    local shard, a plain tensor whole)."""
    total = 0
    for t in _tensors(tree):
        t = t.to_local() if sharding.is_dtensor(t) else t
        total += t.numel() * t.element_size()
    return total


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0
    #: bytes inside kernels: always 0 here (see the module docstring)
    kernel_bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())


# DTensor's sharding propagator infers output shapes by running each op on
# fake tensors of the global shapes; the counter ignores what runs inside it
_PROPAGATING = {"depth": 0}


@contextlib.contextmanager
def _mark_shape_inference():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def marked(self, *args, **kwargs):
        _PROPAGATING["depth"] += 1
        try:
            return orig(self, *args, **kwargs)
        finally:
            _PROPAGATING["depth"] -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


class CostCounter(TorchDispatchMode):
    """Counts one rank's work while it is active (``with CostCounter() as c``).

    ``totals`` holds FLOPs, bytes and collective bytes; ``kernels`` each
    booked kernel's calls, FLOPs and bytes; ``temp_bytes`` the peak of the
    bytes allocated during the count and still held; ``argument_bytes`` what
    ``track_arguments`` recorded."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self.totals = Totals()
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.argument_bytes = 0
        self.live_bytes = 0
        self.temp_bytes = 0
        self._known: Dict[int, int] = {}  # storage key -> bytes (0: an argument's)
        #: (op, input signature) -> the outputs' tree and metadata on meta
        #: tensors (None: run every kernel)
        self._meta_outputs: Optional[Dict[Any, Any]] = {}
        self._stack = contextlib.ExitStack()
        self._depth = 0  # the mode re-enters itself to count decompositions

    # ---- memory ---------------------------------------------------------------
    def _forget(self, key: int, nbytes: int) -> None:
        if self._known.pop(key, None) is not None:
            self.live_bytes -= nbytes

    def _register(self, t: torch.Tensor, argument: bool = False) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known:
            return
        nbytes = 0 if argument else st.nbytes()
        self._known[key] = nbytes
        self.live_bytes += nbytes
        self.temp_bytes = max(self.temp_bytes, self.live_bytes)
        weakref.finalize(st, self._forget, key, nbytes)

    def track_arguments(self, *trees: Any) -> int:
        """Record the step's argument tensors (their storages are not
        temporaries) and add their local bytes to ``argument_bytes``."""
        for tree in trees:
            for t in _tensors(tree):
                local = t.to_local() if sharding.is_dtensor(t) else t
                self._register(local, argument=True)
            self.argument_bytes += local_bytes(tree)
        return self.argument_bytes

    # ---- kernels --------------------------------------------------------------
    def _book(self, name: str, work: cost.Work) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += work.flops
        k["bytes"] += work.bytes
        self.totals.flops += work.flops
        self.totals.bytes += work.bytes

    def __enter__(self):
        if self._depth == 0:
            import torch.fx.experimental._config as fx_config

            self._stack.enter_context(_mark_shape_inference())
            self._stack.enter_context(cost.booking(self._book))
            self._stack.enter_context(fx_config.patch(meta_nonzero_assume_all_nonzero=True))
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._depth -= 1
            if self._depth == 0:
                self._stack.close()

    # ---- ops ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(sharding.is_dtensor(a) for a in flat):
            return NotImplemented  # DTensor's dispatch brings the local ops back here
        if _PROPAGATING["depth"]:
            return func(*args, **kwargs)
        if func._overloadpacket not in self._formulas:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = self._run(func, args, kwargs, flat)
        self._count(func, args, kwargs, flat, out)
        if not _returns_alias(func):  # views, in-place and out= ops make no storage
            for t in _tensors(out):
                self._register(t)
        return out

    def _run(self, func, args, kwargs, flat):
        """``func(*args, **kwargs)``, or on meta tensors the outputs of an
        earlier call with the same signature made afresh (module docstring)."""
        memo = self._meta_outputs
        if memo is None or not _memoizable(func):
            return func(*args, **kwargs)
        sig, tensors = [], 0
        for a in flat:
            if isinstance(a, torch.Tensor):
                if a.device.type != "meta" or type(a) is not torch.Tensor:
                    return func(*args, **kwargs)
                sig.append((tuple(a.shape), a.stride(), a.dtype))
                tensors += 1
            elif isinstance(a, (bool, int, float, str, torch.dtype, torch.device, torch.layout,
                                torch.memory_format)) or a is None:
                sig.append(a)
            else:
                return func(*args, **kwargs)
        if not tensors:  # a factory op: its device is an argument, not an input's
            return func(*args, **kwargs)
        key = (func, tuple(sig))
        hit = memo.get(key)
        if hit is None:
            out = func(*args, **kwargs)
            leaves, spec = tree_flatten(out)
            if all(t.device.type == "meta" for t in leaves if isinstance(t, torch.Tensor)):
                memo[key] = (spec, [_Meta(tuple(t.shape), t.stride(), t.dtype)
                                    if isinstance(t, torch.Tensor) else t for t in leaves])
            return out
        spec, leaves = hit
        return tree_unflatten([torch.empty_strided(m.shape, m.stride, dtype=m.dtype, device="meta")
                               if isinstance(m, _Meta) else m for m in leaves], spec)

    def _count(self, func, args, kwargs, flat, out) -> None:
        outs = _tensors(out)
        formula = self._formulas.get(func._overloadpacket)
        if formula is not None:
            self.totals.flops += formula(*args, **kwargs, out_val=out)
        name = func._overloadpacket.__name__
        if func.namespace in _COLLECTIVE_NS:
            kind = _COLLECTIVE_OPS.get(name)
            if kind is None:  # wait_tensor and autograd wrappers move nothing
                return
            ins = sum(_read_bytes(t) for t in flat if isinstance(t, torch.Tensor))
            cb = self.totals.collective_bytes
            cb[kind] = cb.get(kind, 0.0) + ins
            self.totals.bytes += ins + sum(_read_bytes(t) for t in outs)
            return
        if not outs or func.is_view or func in _NO_BYTES:
            return
        if func in _GATHERS:
            ib = sum(_read_bytes(t) for t in _tensors(args[_GATHERS[func]]))
            self.totals.bytes += 2 * sum(_read_bytes(t) for t in outs) + ib
            return
        if func in _SCATTERS:
            upd, idx = _SCATTERS[func]
            ub = sum(_read_bytes(t) for t in _tensors(args[upd]))
            ib = sum(_read_bytes(t) for t in _tensors(args[idx]))
            self.totals.bytes += 2 * ub + ib
            return
        writes = sum(_read_bytes(t) for t in outs)
        if func in _WRITE_ONLY:
            self.totals.bytes += writes
            return
        if func is _aten.copy_.default:
            self.totals.bytes += _read_bytes(args[1]) + writes
            return
        self.totals.bytes += writes + sum(_read_bytes(t) for t in flat
                                          if isinstance(t, torch.Tensor))
