"""Device meshes — counterpart of ``repro.launch.mesh``.

A mesh spans the ranks of the initialized default process group, one
device per rank, with the reference's axes ``("data", "model")``.  The
mesh's device type is the tensors': ``"cpu"`` under gloo on the CPU,
``"cuda"`` on a card.  Two ranks may share one card (gloo moves CUDA
tensors through the host); NCCL refuses that.

:func:`make_production_mesh` is the production layout: (16, 16) over
``("data", "model")``, or (2, 16, 16) over ``("pod", "data", "model")``.
It is a function, so importing this module touches no device or
process-group state.  :func:`fake_process_group` runs it without 256 ranks:
this process becomes rank 0 of a group whose collectives move nothing
(the dry run's group).

DTensor issues its collectives as ``torch.ops._c10d_functional`` ops.
:func:`stage_through_host` gives those ops CUDA kernels that run the
collective on host copies of their inputs through gloo's CPU path and copy
the result back: the explicit route for a gloo group whose CUDA path does
not carry a functional collective.  It is installed only where a caller
asks.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.distributed as dist

__all__ = ["fake_process_group", "make_local_mesh", "make_production_mesh",
           "mesh_axis_sizes", "mesh_devices", "stage_through_host"]


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production :class:`DeviceMesh` over the default process group:
    (16, 16) over ``("data", "model")``, or (2, 16, 16) over ``("pod",
    "data", "model")`` with ``multi_pod``, on ``device``'s type (default:
    CUDA).  Raises ``ValueError`` unless the group has 256 or 512 ranks
    to match."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh needs an initialized process group")
    n, want = dist.get_world_size(), math.prod(shape)
    if n != want:
        raise ValueError(
            f"the production mesh {shape} needs {want} ranks (256 for one "
            f"pod, 512 for two), but the process group has {n}")
    dev_type = "cuda" if device is None else torch.device(device).type
    return init_device_mesh(dev_type, shape, mesh_dim_names=axes)


@contextlib.contextmanager
def fake_process_group(world: int):
    """A default process group of ``world`` ranks with this process as rank
    0, whose collectives return at once without moving data (torch's
    ``"fake"`` backend); destroyed on exit.  Raises if a group is already
    initialized."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_local_mesh(*, data: int | None = None, model: int | None = None,
                    device=None):
    """A ``("data", "model")`` :class:`DeviceMesh` over the process group's
    world, on ``device``'s type (default: CUDA).

    Defaults put every rank on the "model" axis (a (1, n) mesh: tensor
    parallelism across whatever is available, the sharded-tier serving
    shape).  ``data=`` / ``model=`` override either axis; an unset axis
    absorbs the remaining ranks.  Asking for more ranks than the world
    has raises ``ValueError``."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialized process group")
    n = dist.get_world_size()
    if data is None and model is None:
        data, model = 1, n
    elif data is None:
        data = max(n // model, 1)
    elif model is None:
        model = max(n // data, 1)
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1: data={data}, model={model}")
    if data * model > n:
        raise ValueError(
            f"requested mesh ({data}, {model}) = {data * model} devices, "
            f"but only {n} are available (start more ranks)")
    if data * model < n:
        raise ValueError(
            f"mesh ({data}, {model}) covers {data * model} of the world's "
            f"{n} ranks; a mesh spans the whole world")
    dev_type = "cuda" if device is None else torch.device(device).type
    return init_device_mesh(dev_type, (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size.  A :class:`DeviceMesh` names its dims; a
    duck-typed mesh (the policy tests') has a dict ``shape``."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_devices(mesh) -> int:
    """Shard width of a tier running on ``mesh``: the device count across
    every mesh axis (None = 1).  This is the ``TierSpec.devices`` term of
    the sharding-aware partition cost (compute scales 1/devices, plus the
    intra-tier collective term)."""
    if mesh is None:
        return 1
    return int(math.prod(mesh_axis_sizes(mesh).values()))


_staged: list = []


def _host(x):
    """A host copy of ``x`` (a copy also when ``x`` is on the host)."""
    return x.detach().to("cpu", copy=True).contiguous()


def _group(name):
    from torch.distributed.distributed_c10d import _resolve_process_group

    return name if isinstance(name, dist.ProcessGroup) else _resolve_process_group(name)


def _all_gather(x, group_size, group_name):
    """``all_gather_into_tensor`` on a host copy: the ranks' inputs stacked
    along dim 0, back on ``x``'s device."""
    h = _host(x)
    out = torch.empty((group_size * h.shape[0], *h.shape[1:]), dtype=h.dtype)
    dist.all_gather_into_tensor(out, h, group=_group(group_name))
    return out.to(x.device)


def stage_through_host() -> tuple[str, ...]:
    """Give the functional ``all_gather_into_tensor`` a CUDA kernel that
    runs on host copies through gloo (see the module doc): with torch 2.11
    (two ranks sharing one H100) it never returns on either rank for CUDA
    tensors, while ``all_reduce``, ``reduce_scatter_tensor`` and
    ``all_to_all_single`` return the right values, and every eager c10d call
    takes CUDA tensors.  Idempotent; returns the ops moved."""
    if not _staged:
        lib = torch.library.Library("_c10d_functional", "IMPL")
        lib.impl("all_gather_into_tensor", _all_gather, "CUDA")
        _staged.append(lib)
    return ("all_gather_into_tensor",)
