"""Activation-sharding context — counterpart of ``repro.sharding.ctx``.

Model code is mesh-agnostic (the CPU tests run without any mesh), but a
sharded segment wants a few activations in a chosen layout: the reference
constrains them for XLA's propagation, the port redistributes the DTensor
there (a partial sum is reduced, a shard is gathered or split).

A sharded segment runs under :func:`activation_sharding`; the model calls
:func:`constrain`, which returns its input unchanged when no context is
active or the input is a plain tensor, so every unsharded run stays bitwise
as it was.  Layout strings have one character per dim: ``b`` batch (sharded
over the batch axes when divisible), ``v`` model-shardable (vocab, heads),
``.`` replicated.

The rest are the helpers of the call sites where DTensor has no rule and
the port works on each rank's shard explicitly (the ring writes, the
attention, a head-splitting reshape): each is the identity on a plain
tensor.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.launch.mesh import mesh_axis_sizes

__all__ = ["activation_sharding", "constrain", "mesh_context", "is_dtensor", "local_rows", "plain",
           "like", "local", "local_part", "merge_dims", "split_dim", "to_layout_of"]

_ACTIVE: tuple | None = None


@contextlib.contextmanager
def activation_sharding(mesh, batch_axes: tuple[str, ...], model_axis: str = "model"):
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = (mesh, tuple(batch_axes), model_axis)
    try:
        yield
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def mesh_context(mesh, batch_axes: tuple[str, ...], model_axis: str = "model"):
    """The context a sharded step runs in: :func:`activation_sharding`,
    with plain tensors meeting DTensors counted as replicated (DTensor's
    ``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    with activation_sharding(mesh, batch_axes, model_axis), implicit_replication():
        yield


def layout_spec(layout: str, shape, batch_axes, model_axis: str, sizes) -> tuple:
    """A layout string as a spec (one entry per dim)."""
    spec = []
    for ch, dim in zip(layout, shape):
        if ch == "b":
            axes, size = [], 1
            for a in batch_axes:
                if dim % (size * sizes[a]) == 0:
                    axes.append(a)
                    size *= sizes[a]
            spec.append((axes[0] if len(axes) == 1 else tuple(axes)) if axes else None)
        elif ch == "v":
            spec.append(model_axis if dim % sizes[model_axis] == 0 else None)
        else:
            spec.append(None)
    return tuple(spec)


def constrain(x: torch.Tensor, layout: str) -> torch.Tensor:
    """``x`` redistributed to ``layout`` under an active context when it is
    a DTensor; ``x`` itself otherwise."""
    from repro_torch.sharding.policy import placements

    if _ACTIVE is None or not is_dtensor(x):
        return x
    mesh, batch_axes, model_axis = _ACTIVE
    assert len(layout) == x.dim(), (layout, tuple(x.shape))
    spec = layout_spec(layout, x.shape, batch_axes, model_axis,
                       mesh_axis_sizes(mesh))
    return x.redistribute(mesh, placements(spec, mesh))


def split_dim(x: torch.Tensor, dim: int, sizes: tuple[int, ...]) -> torch.Tensor:
    """``x`` with dim ``dim`` reshaped into ``sizes``.  DTensor cannot
    unflatten a shard that splits the outermost new dim unevenly (Phi-3-
    medium's 1,280 K/V columns over 4 are 2.5 heads of 128), so such a
    DTensor is gathered over that mesh axis first."""
    dim = dim % x.dim()
    shape = (*x.shape[:dim], *sizes, *x.shape[dim + 1:])
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        pl = list(x.placements)
        sizes_m = x.device_mesh.shape
        uneven = [i for i, p in enumerate(pl)
                  if isinstance(p, Shard) and p.dim % x.dim() == dim
                  and sizes[0] % sizes_m[i] != 0]
        if uneven:
            for i in uneven:
                pl[i] = Replicate()
            x = x.redistribute(x.device_mesh, pl)
    return x.reshape(shape)


def merge_dims(x: torch.Tensor, start: int) -> torch.Tensor:
    """``x`` with dims ``start`` .. last flattened into one.  A DTensor is
    flattened on each rank's local tensor, sharded at most on the first of
    those dims (a shard of a later one is gathered first): DTensor's own
    view gives the backward pass a gradient sharded over the merged dim,
    which it cannot unflatten when the shard splits the first dim unevenly
    (2 KV heads over 4 ranks).  A plain tensor is reshaped."""
    start %= x.dim()
    if not is_dtensor(x):
        return x.reshape(*x.shape[:start], -1)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = x.device_mesh
    pl = [Replicate() if isinstance(p, Shard) and p.dim % x.dim() > start else p
          for p in x.placements]
    loc = x.redistribute(mesh, pl).to_local()
    loc = loc.reshape(*loc.shape[:start], -1)
    return DTensor.from_local(loc, mesh, pl, run_check=False)


def local_part(x: torch.Tensor, placements, partial_grad=()) -> torch.Tensor:
    """``x`` (a DTensor) redistributed to ``placements`` and taken as this
    rank's local tensor, for a call site that computes on local tensors.
    Where the other operands of that computation are sharded over mesh dim
    i (the batch) and ``x`` is not, each rank's gradient of ``x`` is its
    share of a sum: list those dims in ``partial_grad`` and the backward
    pass reduces them (DTensor would read the local gradients as whole).
    Where ``x`` is taken as a partial sum, each rank's term has the whole
    gradient (``Replicate``)."""
    from torch.distributed.tensor import Partial, Replicate

    grad = [Partial() if i in partial_grad else Replicate() if p.is_partial() else p
            for i, p in enumerate(placements)]
    return x.redistribute(x.device_mesh, placements).to_local(grad_placements=grad)


def local_rows(x: torch.Tensor, dim: int = 0):
    """(the local tensor, the global index of its first entry along
    ``dim``): a DTensor's shard on this rank (``dim`` split evenly over its
    mesh axes, as the policy places a batch only where the axes divide
    it), or a plain tensor and 0."""
    if not is_dtensor(x):
        return x, 0
    from torch.distributed.tensor import Shard

    mesh, off, width = x.device_mesh, 0, x.shape[dim]
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.dim() == dim % x.dim():
            width //= mesh.size(i)
            off += mesh.get_local_rank(i) * width
    return x.to_local(), off


def plain(x):
    """A DTensor's full value as a plain tensor on this rank (gathered or
    reduced as its placements need); anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def local(x):
    """A DTensor's local tensor on this rank; anything else as it is."""
    return x.to_local() if is_dtensor(x) else x


def like(values: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """This rank's part of ``values`` for ``buf``'s shard, dims aligned one
    to one (``buf`` a DTensor; ``values`` a DTensor or a whole tensor)."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = buf.device_mesh
    if not is_dtensor(values):
        values = DTensor.from_local(values, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    return values.redistribute(mesh, buf.placements).to_local()


def to_layout_of(values: torch.Tensor, buf: torch.Tensor, shift: int) -> torch.Tensor:
    """This rank's part of ``values`` for a write into ``buf``'s shard:
    ``values`` dim j meets ``buf`` dim j + ``shift`` (j >= 1), so it takes
    ``buf``'s shards of those dims; its dim 0 (the written rows) is whole."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = buf.device_mesh
    target = [Shard(p.dim - shift) if isinstance(p, Shard) and p.dim - shift >= 1
              else Replicate() for p in buf.placements]
    if not is_dtensor(values):
        values = DTensor.from_local(values, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    return values.redistribute(mesh, target).to_local()


def is_dtensor(x) -> bool:
    global _DTensor
    if _DTensor is None:
        from torch.distributed.tensor import DTensor as _DTensor
    return isinstance(x, _DTensor)


_DTensor = None
