"""Fused exit decision (normalized entropy + threshold flag + argmax token)
of K stacked branch heads: the Hopper kernel's launcher.

Replaces ``repro/kernels/entropy_exit.py::entropy_exit_argmax_heads_pallas``
and, as its K = 1 launch, ``entropy_exit_argmax_pallas``; the same kernel
with the argmax compiled out replaces ``entropy_exit_pallas``
(:func:`entropy_exit_cuda`).  The kernel is
``csrc/entropy_exit.cu`` (CUDA C++, sm_90a, plain C interface); its source
note says what bounds it on the H100 and how the design answers that:
each row's V is cut into :func:`split_plan`'s ``SPLITS`` splits, one block
of a thread-block cluster each, merged inside the cluster in one launch;
the launchers pass the plan's split to the C entry point, which has no
copy of it.  The C entry point picks the load width (:func:`load_width`)
from V and the logits' address; both widths give the same bits.  The
plain PyTorch version is
:func:`repro_torch.kernels.ref.entropy_exit_argmax_heads_ref`;
:mod:`repro_torch.kernels.ops` dispatches between the two by the device of
the logits and counts launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import load

__all__ = [
    "SPLITS",
    "entropy_exit_argmax_heads_cuda",
    "entropy_exit_cuda",
    "load_width",
    "split_plan",
]

#: Blocks per cluster = splits per row (``kSplits`` in the source).
SPLITS = 8
#: Elements per 16-byte group; a split is a whole number of groups.
_GROUP = 8

_ARGTYPES = {
    "entropy_exit_argmax_bf16": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_void_p],
    "entropy_exit_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.c_float, ctypes.c_void_p],
    "entropy_exit_load_width": [ctypes.c_void_p, ctypes.c_int],
}
_fns: dict = {}


def _fn(name: str):
    f = _fns.get(name)
    if f is None:
        f = getattr(load("entropy_exit"), name)
        f.argtypes = _ARGTYPES[name]
        f.restype = ctypes.c_int
        _fns[name] = f
    return f


def split_plan(v: int) -> tuple[int, int]:
    """(elements per split, number of splits) of a row of width ``v``:
    ceil(v / SPLITS) rounded up to whole groups.  It depends on ``v`` only,
    so a row's result does not depend on K, B or the data; splits past the
    row's end are empty.  The launchers pass the split to the kernel."""
    per = -(-v // SPLITS)
    return -(-per // _GROUP) * _GROUP, SPLITS


def load_width(logits: torch.Tensor) -> int:
    """Elements per load of the instantiation the C entry point picks for
    these CUDA logits, asked of the kernel's library: 8 (16-byte loads)
    when V % 8 == 0 and the logits are 16-byte aligned, else 1 (scalars)."""
    return _fn("entropy_exit_load_width")(logits.data_ptr(), logits.shape[-1])


def _thresholds(thresholds, k: int, device) -> torch.Tensor:
    if isinstance(thresholds, torch.Tensor):
        th = thresholds.to(device=device, dtype=torch.float32).reshape(-1)
        if th.numel() not in (1, k):
            raise ValueError(f"thresholds must be a scalar or ({k},)")
        return th.expand(k).contiguous()
    return torch.full((k,), float(thresholds), dtype=torch.float32,
                      device=device)


def _check_logits(logits: torch.Tensor, dims: int, layout: str) -> torch.Tensor:
    if not logits.is_cuda:
        raise ValueError("entropy_exit kernel needs a CUDA tensor")
    if logits.dtype != torch.bfloat16 or logits.dim() != dims:
        raise ValueError(
            f"logits must be {layout} bfloat16, got {tuple(logits.shape)} "
            f"{logits.dtype}")
    return logits.contiguous()


def entropy_exit_cuda(logits: torch.Tensor, threshold
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the no-argmax kernel on (B, V) bf16 CUDA logits.  Returns
    (entropy (B,) f32, flag (B,) bool), enqueued on the current stream."""
    logits = _check_logits(logits, 2, "(B, V)")
    b, v = logits.shape
    th = _thresholds(threshold, 1, logits.device)
    h = torch.empty((b,), dtype=torch.float32, device=logits.device)
    flag = torch.empty((b,), dtype=torch.bool, device=logits.device)
    err = _fn("entropy_exit_bf16")(
        logits.data_ptr(), th.data_ptr(), h.data_ptr(), flag.data_ptr(),
        1, b, v, split_plan(v)[0], float(math.log(v)),
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"entropy_exit kernel launch failed: cudaError {err}")
    return h, flag


def entropy_exit_argmax_heads_cuda(
    logits: torch.Tensor, thresholds
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on (K, B, V) bf16 CUDA logits; ``thresholds`` is a
    float or a scalar / (K,) tensor.  Returns (entropy (K, B) f32, flag
    (K, B) bool, token (K, B) int32), enqueued on the current stream."""
    logits = _check_logits(logits, 3, "(K, B, V)")
    k, b, v = logits.shape
    th = _thresholds(thresholds, k, logits.device)
    h = torch.empty((k, b), dtype=torch.float32, device=logits.device)
    flag = torch.empty((k, b), dtype=torch.bool, device=logits.device)
    idx = torch.empty((k, b), dtype=torch.int32, device=logits.device)
    err = _fn("entropy_exit_argmax_bf16")(
        logits.data_ptr(), th.data_ptr(), h.data_ptr(), flag.data_ptr(),
        idx.data_ptr(), k, b, v, split_plan(v)[0], float(math.log(v)),
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"entropy_exit kernel launch failed: cudaError {err}")
    return h, flag, idx
