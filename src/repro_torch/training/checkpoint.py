"""Checkpoints: flat-key ``.npz`` save / restore of params and optimizer
trees — counterpart of ``repro.training.checkpoint``, in its format, so
that each package restores the other's files.

  * keys are the tree paths joined with ``##`` (dict keys, list indices);
  * ``__manifest__`` holds the step and each key's shape and dtype;
  * a write goes to a temporary file in the target's directory, then is
    renamed over the target (atomic);
  * a restore follows the structure of ``like``: a missing key or a wrong
    shape raises, extra keys are ignored (partial restore, e.g. the params
    of a train checkpoint for serving).

bf16: numpy has no bfloat16 without ``ml_dtypes``, which the port does not
need, and a bf16 leaf the reference wrote loads as a 2-byte void array.
The port reads those as uint16 bits shifted into float32 (exact), and
writes its own bf16 leaves as float32 with ``"bfloat16"`` in the manifest,
which the reference's ``arr.astype(leaf.dtype)`` restores exactly.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device
from repro_torch.training.tree import tree_items, tree_map

__all__ = ["save_checkpoint", "restore_checkpoint", "checkpoint_manifest"]

_SEP = "##"


def _key(path: tuple) -> str:
    return _SEP.join(str(k) for k in path)


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = torch.as_tensor(t).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.float().numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_saved(arr: np.ndarray) -> np.ndarray:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bf16 bits
        return (arr.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return arr


def save_checkpoint(path: str, tree: Any, step: int | None = None) -> None:
    """Atomic: write to a temporary file in the same directory, then
    rename."""
    flat, keys = {}, {}
    for p, leaf in tree_items(tree):
        key = _key(p)
        flat[key], dtype = _to_numpy(leaf)
        keys[key] = {"shape": list(flat[key].shape), "dtype": dtype}
    manifest = {"step": step, "keys": keys}
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __manifest__=json.dumps(manifest), **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def checkpoint_manifest(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return json.loads(str(z["__manifest__"]))


def restore_checkpoint(path: str, like: Any, device=None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, which may
    live on the ``meta`` device): each leaf takes ``like``'s dtype and
    lands on ``device`` (default: the current CUDA device).  Missing keys
    raise ``KeyError``, wrong shapes ``ValueError``; extra keys are
    ignored."""
    device = resolve_device(device)
    with np.load(path, allow_pickle=False) as z:
        saved = {k: z[k] for k in z.files if k != "__manifest__"}
    out = {}
    for p, leaf in tree_items(like):
        key = _key(p)
        if key not in saved:
            raise KeyError(f"checkpoint missing {key}")
        arr = saved[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != expected {tuple(leaf.shape)}")
        out[key] = torch.from_numpy(_from_saved(arr).copy()).to(
            device=device, dtype=leaf.dtype)
    paths = iter(_key(p) for p, _ in tree_items(like))
    return tree_map(lambda _: out[next(paths)], like)
