"""Sharding policy: param, cache and activation specs per architecture —
counterpart of ``repro.sharding.policy``.

Axis conventions (the reference's):

  * ``data`` (+ ``pod`` when present) — batch parallelism; also the FSDP
    axes for configs with ``cfg.fsdp``;
  * ``model`` — tensor parallelism: attention projections, FFN hidden,
    expert dim, vocab.

Every rule checks divisibility and falls back to replication (Phi-3-medium's
kv = 10 heads, Whisper's 51,865 vocab).  KV caches shard kv-heads over
``model`` when divisible, else ``head_dim``.

A spec is a tuple with one entry per tensor dim: a mesh-axis name, a tuple
of axis names (a 1-tuple reads as its name, as ``PartitionSpec`` normalizes
it), or None — the reference's ``PartitionSpec`` read as a tuple and padded
with None to the tensor's rank.  The rules read only ``mesh.shape`` (through
:func:`~repro_torch.launch.mesh.mesh_axis_sizes`), so a duck-typed mesh
drives them without a process group.  :func:`placements` turns a spec into
``torch.distributed.tensor`` placements on a real ``DeviceMesh``;
:meth:`ShardingPolicy.shard_params` / :meth:`~ShardingPolicy.shard_caches`
place a tree.  Trees are the port's nested dicts (and Whisper's
``cross_kv`` tuple); a leaf's path joins its keys with ``/`` (a tuple
entry by its index), as the reference joins its key paths.

:func:`param_shapes` / :func:`cache_shapes` give a config's trees on the
``meta`` device: shapes and dtypes with no memory behind them, so the
full-size walk costs nothing (DeepSeek-V3 is 1.34 TB in bf16).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Iterator

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import mesh_axis_sizes

__all__ = [
    "ShardingPolicy",
    "cache_shapes",
    "make_policy",
    "param_shapes",
    "placements",
    "spec_at",
    "tree_paths",
]

Spec = tuple  # one entry per tensor dim: str | tuple[str, ...] | None


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def _entry(e):
    """A spec entry as ``PartitionSpec`` normalizes it (a 1-tuple is its
    name)."""
    if isinstance(e, tuple):
        return e[0] if len(e) == 1 else (e or None)
    return e


def _spec(rank: int, *dims) -> Spec:
    """Leading Nones, then ``dims`` for the trailing dims."""
    return (None,) * (rank - len(dims)) + tuple(_entry(d) for d in dims)


def tree_paths(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) of every leaf of a nested dict / tuple tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def spec_at(specs, path: str) -> Spec:
    """The spec at ``path`` of a tree of specs (nested dicts whose leaves
    are spec tuples, as :meth:`ShardingPolicy.opt_state_shardings` gives)."""
    for key in path.split("/"):
        specs = specs[key]
    return specs


def _map_paths(fn, tree, prefix: str = ""):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_paths(fn, v, f"{prefix}{i}/")
                          for i, v in enumerate(tree))
    return fn(prefix[:-1], tree)


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    mesh: Any
    cfg: ModelConfig
    batch_axes: tuple[str, ...]  # ("pod", "data") or ("data",)
    model_axis: str = "model"

    # ------------------------------------------------------------ helpers
    @property
    def axes(self) -> dict[str, int]:
        return mesh_axis_sizes(self.mesh)

    def _axis_size(self, name) -> int:
        if isinstance(name, tuple):
            return math.prod(self.axes[a] for a in name)
        return self.axes[name]

    def _maybe(self, axis, dim: int):
        """``axis`` if it divides ``dim``, else None (replicate)."""
        return axis if _div(dim, self._axis_size(axis)) else None

    def _fsdp_axes(self) -> tuple[str, ...] | None:
        if not self.cfg.fsdp:
            return None
        axes = tuple(a for a in self.cfg.fsdp_axes if a in self.axes)
        return axes or None

    # ------------------------------------------------------------ params
    def param_spec(self, path: str, shape: tuple[int, ...]) -> Spec:
        """The reference's rule table, keyed on the param's tree path.
        Stacked trunk params carry a leading layer axis (never sharded)."""
        cfg, tp, fsdp = self.cfg, self.model_axis, self._fsdp_axes()
        shape = tuple(shape)
        rank = len(shape)

        def spec(*dims):
            return _spec(rank, *dims)

        def fs(dim):
            return fsdp and self._maybe(fsdp, dim)

        leaf = path.split("/")[-1]
        # ---- embeddings / heads
        if leaf == "embed":
            return spec(self._maybe(tp, shape[0]), fs(shape[1]))
        if leaf == "lm_head":
            return spec(fs(shape[0]), self._maybe(tp, shape[1]))
        # ---- attention
        if re.search(r"(attn|xattn)/(wq|wk|wv|wq_b|wk_b|wv_b|wq_a|wkv_a)$", path):
            return spec(fs(shape[-2]), self._maybe(tp, shape[-1]))
        if re.search(r"(attn|xattn)/wo$", path):
            return spec(self._maybe(tp, shape[-2]), fs(shape[-1]))
        # ---- dense MLP
        if re.search(r"mlp/(w_gate|w_up)$", path):
            return spec(fs(shape[-2]), self._maybe(tp, shape[-1]))
        if re.search(r"mlp/w_down$", path):
            return spec(self._maybe(tp, shape[-2]), fs(shape[-1]))
        # ---- MoE: expert axis on "model"; FSDP over the hidden dims.
        if re.search(r"moe/(w_gate|w_up|w_down)$", path):
            e = shape[-3]
            if cfg.expert_parallel:
                # Expert parallelism over the whole mesh.
                ep_axes = tuple(a for a in ("data", "model") if a in self.axes)
                if _div(e, self._axis_size(ep_axes)):
                    return spec(ep_axes, None, None)
            if cfg.moe_fsdp_dim == "ff" and fsdp:
                # FSDP over the expert-hidden dim (w_down's rows, the
                # others' columns).
                ff_idx = -2 if path.endswith("w_down") else -1
                dims = [self._maybe(tp, e), None, None]
                dims[2 + ff_idx + 1] = self._maybe(fsdp, shape[ff_idx])
                return spec(*dims)
            return spec(self._maybe(tp, e), fs(shape[-2]), None)
        if re.search(r"moe/router$", path):
            return spec(fs(shape[-2]), None)
        if re.search(r"moe/shared/(w_gate|w_up)$", path):
            return spec(fs(shape[-2]), self._maybe(tp, shape[-1]))
        if re.search(r"moe/shared/w_down$", path):
            return spec(self._maybe(tp, shape[-2]), fs(shape[-1]))
        # ---- Mamba2
        if re.search(r"mamba/(w_z|w_xbc)$", path):
            return spec(fs(shape[-2]), self._maybe(tp, shape[-1]))
        if re.search(r"mamba/out_proj$", path):
            return spec(self._maybe(tp, shape[-2]), fs(shape[-1]))
        if re.search(r"mamba/w_dt$", path):
            return spec(fs(shape[-2]), None)
        if re.search(r"mamba/conv_w$", path):
            return spec(None, self._maybe(tp, shape[-1]))
        if re.search(r"mamba/(conv_b|norm_scale)$", path):
            return spec(self._maybe(tp, shape[-1]))
        # ---- everything else (norms, scalars): replicated.
        return spec()

    def param_specs(self, params) -> Any:
        """The spec of every leaf of a param tree (tensors, meta tensors or
        anything with a ``shape``)."""
        return _map_paths(lambda p, t: self.param_spec(p, tuple(t.shape)), params)

    # ------------------------------------------------------------ data
    def batch_spec_axes(self, batch_size: int):
        """Largest prefix of the batch axes that divides ``batch_size``
        (None: replicate)."""
        axes, size = [], 1
        for a in self.batch_axes:
            if batch_size % (size * self.axes[a]) == 0:
                axes.append(a)
                size *= self.axes[a]
        return _entry(tuple(axes)) if axes else None

    def data_spec(self, shape: tuple[int, ...]) -> Spec:
        """Token-like inputs: batch over (pod, data) when divisible."""
        return (self.batch_spec_axes(shape[0]),) + (None,) * (len(shape) - 1)

    # ------------------------------------------------------------ caches
    def cache_spec(self, path: str, shape: tuple[int, ...]) -> Spec:
        """KV / SSM / latent caches.  The leading axis is the stacked layer
        axis for trunk caches; batch comes next."""
        tp = self.model_axis
        shape = tuple(shape)
        rank = len(shape)
        leaf = path.split("/")[-1]
        if leaf in ("length", "pos"):
            return (None,) * rank

        def bsp(batch_dim_from_end: int):
            return self.batch_spec_axes(shape[-batch_dim_from_end])

        if leaf in ("k", "v") or "cross_kv" in path:
            # (L, B, C, K, D): kv-heads on model if divisible, else head_dim.
            kh, hd = shape[-2], shape[-1]
            if _div(kh, self._axis_size(tp)):
                return _spec(rank, bsp(4), None, tp, None)
            return _spec(rank, bsp(4), None, None, self._maybe(tp, hd))
        if leaf in ("ckv", "k_rope"):
            # MLA latent: batch and the latent dim.
            return _spec(rank, bsp(3), None, self._maybe(tp, shape[-1]))
        if leaf == "ssm":
            # (L, B, H, P, N): heads on model if divisible, else the P dim.
            h, pdim = shape[-3], shape[-2]
            if _div(h, self._axis_size(tp)):
                return _spec(rank, bsp(4), tp, None, None)
            return _spec(rank, bsp(4), None, self._maybe(tp, pdim), None)
        if leaf == "conv":
            return _spec(rank, bsp(3), None, self._maybe(tp, shape[-1]))
        return (None,) * rank

    # ------------------------------------------------------------ placement
    def shard_params(self, params) -> Any:
        """Place a concrete param tree per :meth:`param_spec` (the serving
        entry point: ``TierExecutor`` calls it once at construction)."""
        return _map_paths(
            lambda p, t: distribute(t, self.mesh, self.param_spec(p, t.shape)),
            params)

    def shard_caches(self, caches) -> Any:
        """Place a concrete cache tree per :meth:`cache_spec`; sharded
        decode steps update the placed leaves in place."""
        return _map_paths(
            lambda p, t: distribute(t, self.mesh, self.cache_spec(p, t.shape)),
            caches)

    def shard_opt_state(self, opt_state, params, optimizer_name: str) -> Any:
        """Place a concrete optimizer state tree (``opt.init`` of the
        params) per :meth:`opt_state_shardings`, as :meth:`shard_params`
        places the params."""
        specs = self.opt_state_shardings(params, optimizer_name)
        return _map_paths(
            lambda p, t: distribute(t, self.mesh, spec_at(specs, p)), opt_state)

    # ------------------------------------------------------------ optimizer
    def opt_state_shardings(self, params_shapes, optimizer_name: str) -> Any:
        """Specs of the optimizer state tree.  AdamW's m / v mirror the
        params; Adafactor's factored vr / vc drop the last / second-to-last
        param axis from the spec."""
        if optimizer_name == "adamw":
            ps = self.param_specs(params_shapes)
            return {"m": ps, "v": ps}
        if optimizer_name != "adafactor":
            raise ValueError(optimizer_name)

        def factored(path, leaf):
            spec = self.param_spec(path, tuple(leaf.shape))
            if len(leaf.shape) >= 2:
                return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
            return {"v": spec}

        return _map_paths(factored, params_shapes)

    # ------------------------------------------------------------ misc
    def replicated(self) -> list:
        """The placements of a fully replicated tensor on the mesh."""
        from torch.distributed.tensor import Replicate

        return [Replicate() for _ in self.axes]

    def logits_spec(self) -> Spec:
        return (_entry(self.batch_axes), None,
                self._maybe(self.model_axis, self.cfg.vocab_size))


def make_policy(mesh, cfg: ModelConfig) -> ShardingPolicy:
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh_axis_sizes(mesh))
    return ShardingPolicy(mesh=mesh, cfg=cfg, batch_axes=batch_axes)


# ----------------------------------------------------------------- DTensor
def placements(spec: Spec, mesh) -> list:
    """``spec`` as DTensor placements on ``mesh``, one per mesh dim: a mesh
    axis that shards tensor dim d is ``Shard(d)``; one tensor dim over two
    mesh axes is ``Shard(d)`` on both mesh dims; the rest ``Replicate()``.
    An axis of size 1 splits nothing and is ``Replicate()`` (DTensor's
    rules treat a shard over one device as a shard)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name, size in mesh_axis_sizes(mesh).items():
        dim = next((d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)), None)
        out.append(Replicate() if dim is None or size == 1 else Shard(dim))
    return out


def distribute(t: torch.Tensor, mesh, spec: Spec):
    """``t`` as a DTensor placed per ``spec``.  Every rank holds the same
    ``t`` (drawn from one seed), so each keeps its own shard with no
    communication, as a copy of its own: the full tensor can be freed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = placements(spec, mesh)
    if isinstance(t, DTensor):  # placed already (a server sharing another's params)
        return t.redistribute(mesh, pl)
    dt = distribute_tensor(t, mesh, pl, src_data_rank=None)
    local = dt.to_local()
    if local.untyped_storage().data_ptr() == t.untyped_storage().data_ptr():
        dt = DTensor.from_local(local.clone(), mesh, pl, run_check=False,
                                shape=dt.shape, stride=dt.stride())
    return dt


# ------------------------------------------------------------- shape walk
def param_shapes(cfg: ModelConfig) -> dict:
    """The param tree of ``cfg`` on the ``meta`` device: shapes and dtypes,
    no memory, no draws."""
    from repro_torch.models.model import init_params

    return init_params(cfg, None, device="meta")


def cache_shapes(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """The cache tree of ``cfg`` at ``batch`` x ``seq_len`` on ``meta``."""
    from repro_torch.models.model import init_caches

    return init_caches(cfg, batch, seq_len, device="meta")
