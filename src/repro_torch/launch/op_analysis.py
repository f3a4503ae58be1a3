"""Per-op work counts of one eager call — the role of
``repro.launch.hlo_analysis``, read from the aten ops a call dispatches
rather than from compiled HLO text.

:func:`analyze_ops` runs ``fn`` under a ``TorchDispatchMode`` and counts, per
device (on a mesh, each rank's own ops: a DTensor op is left to DTensor,
which runs the local ops and issues the collectives this mode then sees):

  * ``dot_flops``: 2 * prod(output) * prod(contracting dims) of every
    ``mm`` / ``addmm`` / ``bmm`` / ``baddbmm`` (what ``matmul``, ``einsum``
    and ``linear`` decompose into), the reference's matmul FLOPs;
  * ``hbm_bytes``: the reference's proxy, 2 x the result bytes of every op
    that moves data (every value written once and read about once); views,
    ``detach``, aliases and shape-only ops count nothing, and an in-place
    update of a slice (``index_put_``, ``index_copy_``, ``copy_`` into a
    view, ``slice_scatter``) counts 2 x the update's bytes, as
    ``dynamic-update-slice`` does there;
  * ``hbm_argument_bytes``, beside it and not in it: the bytes each op
    reads from a tensor the call did not make (weights, caches, inputs),
    once per op.  Eager code reads those through views, where XLA copies a
    sliced weight through a ``dynamic-slice`` whose result its proxy
    counts, so a loop over weight slices streams them here under this key;
  * ``collectives``: per type (the reference's names), the largest of
    operand and result bytes of each ``_c10d_functional`` op DTensor issues
    and each in-place ``c10d`` op an explicit ``torch.distributed`` call
    dispatches; ``counts``: how many of each.

The counts are those of the ops this torch runs: on a mesh, DTensor's
choice of strategy for each op (where to gather, which side to shard)
decides the local shapes, so the dot FLOPs and bytes of one step differ
between torch versions (OLMo-1B's ``train_4k`` on (16, 16): 5.638e13 dot
FLOPs a device on torch 2.11, 9.762e13 on 2.13).  They are this program's
work, not the model's.

An eager loop runs its body n times, so trip counts need no correction,
and the recomputation of ``torch.utils.checkpoint`` in a backward pass run
under the mode is counted.  The port's Hopper kernels are reached through
``ctypes`` (``kernels/build.py``), which no dispatch mode sees: analyze
the plain path (``use_kernels=False``, as on the CPU).

The mode also follows the storages the call makes (a finalizer on each)
and reports the peak of their live bytes (``peak_live_bytes``) and the
bytes of the outputs the call made (``output_bytes``).  On ``meta``
tensors (the dry run's) nothing of it allocates.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
import weakref
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["COLLECTIVES", "analyze_ops", "OpCounter"]

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

_COLLECTIVE_OPS = {
    # functional collectives (DTensor, funcol)
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    # in-place c10d ops (``dist.all_reduce`` and friends)
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::send": "collective-permute",
    "c10d::recv_": "collective-permute",
    "c10d::broadcast_": "collective-permute",
}

_DOTS = {"aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm"}

# Ops that move no data: allocation without a write, shape / device
# queries, a host read of a scalar, and the aliasing ops whose schemas do
# not say so.
_NO_TRAFFIC = {
    "aten::empty", "aten::empty_like", "aten::empty_strided",
    "aten::new_empty", "aten::new_empty_strided", "aten::arange",
    "aten::_unsafe_view", "aten::lift_fresh", "aten::_local_scalar_dense",
    "aten::sym_size", "aten::sym_stride", "aten::sym_numel",
    "aten::sym_storage_offset", "aten::is_same_size", "aten::equal",
    "_c10d_functional::wait_tensor",
}

# In-place and functional updates of a slice: (argument name of the update).
_SLICE_UPDATES = {
    "aten::index_put_": "values",
    "aten::_index_put_impl_": "values",
    "aten::index_copy_": "source",
    "aten::slice_scatter": "src",
    "aten::select_scatter": "src",
}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _is_wrapper(cls) -> bool:
    """A tensor subclass whose ops unwrap to inner tensors (DTensor, a
    collective's async wrapper); a fake tensor is not one."""
    from torch.utils._python_dispatch import is_traceable_wrapper_subclass_type

    return cls is not torch.Tensor and is_traceable_wrapper_subclass_type(cls)


_SUSPEND = threading.local()


@contextlib.contextmanager
def _dtensor_meta_uncounted():
    """DTensor works out an op's global output shape by running the op once
    more on fake global-shape tensors; those ops are not this rank's work.
    Returns through this patch uncounted."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:  # no distributed build
        yield
        return
    orig = ShardingPropagator._propagate_tensor_meta_non_cached

    def wrapped(self, *a, **k):
        _SUSPEND.depth = getattr(_SUSPEND, "depth", 0) + 1
        try:
            return orig(self, *a, **k)
        finally:
            _SUSPEND.depth -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig


class OpCounter(TorchDispatchMode):
    """The dispatch mode behind :func:`analyze_ops` (see the module doc)."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0.0
        self.result_bytes = 0.0
        self.argument_bytes = 0.0
        self.collectives = {c: 0.0 for c in COLLECTIVES}
        self.counts = {c: 0 for c in COLLECTIVES}
        self._made: dict[int, int] = {}  # storage key -> bytes, while alive
        self.live_bytes = 0
        self.peak_live_bytes = 0

    # ---------------------------------------------------------- storages
    def _freed(self, key: int) -> None:
        self.live_bytes -= self._made.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._made:
            return
        n = st.nbytes()
        self._made[key] = n
        weakref.finalize(st, self._freed, key)
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)

    def made(self, t: torch.Tensor) -> bool:
        """Whether ``t``'s storage was made inside the call."""
        return _storage_key(t) in self._made

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_wrapper(t) for t in types):
            return NotImplemented  # the subclass runs the local ops
        out = func(*args, **kwargs)
        if getattr(_SUSPEND, "depth", 0) or func.namespace == "prim":
            return out
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        op = _describe(func)
        in_tensors = _tensors((*args, *kwargs.values()))
        out_tensors = _tensors(out if isinstance(out, (tuple, list)) else (out,))

        if op.collective is not None:
            sizes = [_nbytes(t) for t in in_tensors + out_tensors]
            self.collectives[op.collective] += float(max(sizes, default=0))
            self.counts[op.collective] += 1
        if op.dot:  # (batch,) n x k @ k x m, the operands last
            self.dot_flops += 2.0 * math.prod(out_tensors[0].shape) * args[-2].shape[-1]
        if not op.moves:
            return

        written: set[int] = set()
        if op.update is not None:
            self.result_bytes += 2.0 * _nbytes(_arg(func._schema, args, kwargs, op.update))
            if op.writes:
                written = {id(args[0])}
        elif op.writes:
            for name in op.writes:
                t = _arg(func._schema, args, kwargs, name)
                for w in (t if isinstance(t, (list, tuple)) else [t]):
                    if isinstance(w, torch.Tensor):
                        self.result_bytes += 2.0 * _nbytes(w)
                        written.add(id(w))
        else:
            self.result_bytes += 2.0 * sum(_nbytes(o) for o in out_tensors)

        self.argument_bytes += float(sum(
            _nbytes(t) for t in in_tensors
            if id(t) not in written and not self.made(t)))
        if not op.writes:
            for o in out_tensors:
                self._track(o)

    def result(self) -> dict:
        return {
            "collectives": dict(self.collectives),
            "counts": dict(self.counts),
            "dot_flops": self.dot_flops,
            "hbm_bytes": self.result_bytes,
            "hbm_argument_bytes": self.argument_bytes,
        }


class _Op(NamedTuple):
    """What the counter needs of an op, read once from its schema."""

    collective: str | None  # the reference's name of its collective type
    dot: bool  # a matmul
    moves: bool  # moves data (not a view, alias, allocation or query)
    writes: tuple[str, ...]  # the arguments it writes in place
    update: str | None  # the argument holding a slice update


@functools.lru_cache(maxsize=None)
def _describe(func) -> _Op:
    schema = func._schema
    name = schema.name
    writes = tuple(a.name for a in schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write)
    views = not writes and any(r.alias_info is not None for r in schema.returns)
    moves = not (views or name in _NO_TRAFFIC or torch.Tag.inplace_view in func.tags)
    return _Op(_COLLECTIVE_OPS.get(name), name in _DOTS, moves, writes,
               _SLICE_UPDATES.get(name))


def _tensors(values) -> list:
    """The tensors among an op's arguments or results (an aten op nests
    them one list deep at most)."""
    out = []
    for v in values:
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            out.extend(t for t in v if isinstance(t, torch.Tensor))
    return out


def _arg(schema, args, kwargs, name: str):
    for i, a in enumerate(schema.arguments):
        if a.name == name:
            return args[i] if i < len(args) else kwargs.get(name)
    raise KeyError(name)


def analyze_ops(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and count its ops (see the module
    doc).  Returns the reference's keys (``collectives``, ``counts``,
    ``dot_flops``, ``hbm_bytes``), ``hbm_argument_bytes``,
    ``peak_live_bytes``, ``output_bytes``, and ``out``, ``fn``'s return
    value."""
    from repro_torch.sharding.ctx import local

    counter = OpCounter()
    with _dtensor_meta_uncounted(), counter:
        out = fn(*args, **kwargs)
    rec: dict[str, Any] = counter.result()
    rec["peak_live_bytes"] = counter.peak_live_bytes
    made = {}
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor):
            key = _storage_key(local(t))
            if key in counter._made:
                made[key] = counter._made[key]
    rec["output_bytes"] = sum(made.values())
    rec["out"] = out
    return rec
