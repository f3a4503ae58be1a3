"""Carry weights and state between the reference package and the port.

The reference keeps params and caches as pytrees of JAX arrays; the port
keeps the same trees (nested dicts) of torch tensors.  The bridge speaks
numpy on the JAX side, so this module imports no JAX: callers hand it
``jax.tree.map(np.asarray, tree)`` and get numpy trees back.

  * fp32 and int32 arrays transfer bitwise; tuples stay tuples (Whisper's
    ``caches["cross_kv"]`` is a tuple ``(k, v)``);
  * bf16 arrays (``ml_dtypes.bfloat16`` in numpy, which
    ``torch.from_numpy`` cannot take) go through float32, which holds every
    bf16 value exactly, and are cast back to bf16 on the torch side;
  * :func:`caches_to_numpy` returns bf16 tensors as float32 numpy arrays,
    so a cache compares against the reference's ``cache.astype(float32)``;
  * :func:`alexnet_params_from_jax` also changes B-AlexNet's layout
    (NHWC / HWIO in the reference, NCHW / OIHW in the port);
  * :func:`train_state_from_jax` carries a reference train state (params,
    the optimizer's state, the step) so that the port takes its next step.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device

__all__ = ["params_from_jax", "caches_from_jax", "caches_to_numpy",
           "alexnet_params_from_jax", "train_state_from_jax"]


def _to_torch(a, device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.tensor(arr, device=device)  # a copy: JAX's buffers are read-only


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def params_from_jax(tree, device=None) -> dict:
    """A reference params tree (numpy leaves) as the port's tensors on
    ``device`` (default: the current CUDA device)."""
    device = resolve_device(device)
    return _map(tree, lambda a: _to_torch(a, device))


def caches_from_jax(tree, device=None) -> dict:
    """A reference caches tree (numpy leaves) as the port's tensors on
    ``device`` (default: the current CUDA device)."""
    device = resolve_device(device)
    return _map(tree, lambda a: _to_torch(a, device))


def train_state_from_jax(state, device=None) -> dict:
    """A reference train state (``init_train_state``'s tree with numpy
    leaves: ``params``, ``opt`` — AdamW's ``m`` / ``v`` or Adafactor's
    ``vr`` / ``vc`` / ``v`` — and the int32 ``step``) as the port's tensors
    on ``device`` (default: the current CUDA device)."""
    if set(state) != {"params", "opt", "step"}:
        raise ValueError(f"not a train state: keys {sorted(state)}")
    device = resolve_device(device)
    return _map(state, lambda a: _to_torch(a, device))


def caches_to_numpy(tree) -> dict:
    """The port's caches as numpy (bf16 -> float32, exact)."""
    def conv(t: torch.Tensor):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _map(tree, conv)


#: Side of the square map that B-AlexNet's ``fc6`` / ``b1_fc`` flatten.
_FLAT_SIDE = {"fc6": 6, "b1_fc": 13}


def alexnet_params_from_jax(tree, device=None) -> dict:
    """The reference's B-AlexNet params (numpy leaves of
    ``repro.models.alexnet.init_b_alexnet``) in the port's layout on
    ``device`` (default: the current CUDA device): every conv weight HWIO
    -> OIHW, and the input rows of ``fc6`` and ``b1_fc`` from the (H, W, C)
    order of the reference's NHWC flatten to the (C, H, W) order of the
    port's NCHW flatten.  Values transfer bitwise."""
    out = {}
    for name, p in tree.items():
        w = np.asarray(p["w"])
        if w.ndim == 4:
            w = w.transpose(3, 2, 0, 1)
        elif name in _FLAT_SIDE:
            side, dout = _FLAT_SIDE[name], w.shape[1]
            w = w.reshape(side, side, -1, dout).transpose(2, 0, 1, 3).reshape(-1, dout)
        out[name] = {"w": np.ascontiguousarray(w), "b": np.asarray(p["b"])}
    return params_from_jax(out, device)
