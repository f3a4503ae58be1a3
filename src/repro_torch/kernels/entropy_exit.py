"""Fused exit decision (normalized entropy + threshold flag + argmax token)
of K stacked branch heads: the Hopper kernel's launcher.

Replaces ``repro/kernels/entropy_exit.py::entropy_exit_argmax_heads_pallas``
and, as its K = 1 launch, ``entropy_exit_argmax_pallas``; the same kernel
with the argmax compiled out replaces ``entropy_exit_pallas``
(:func:`entropy_exit_cuda`).  The kernel is
``csrc/entropy_exit.cu`` (CUDA C++, sm_90a, plain C interface); its source
note says what bounds it on the H100 and how the design answers that.  The
plain PyTorch version is :func:`repro_torch.kernels.ref.
entropy_exit_argmax_heads_ref`; :mod:`repro_torch.kernels.ops` dispatches
between the two by the device of the logits and counts launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import load

__all__ = ["entropy_exit_argmax_heads_cuda", "entropy_exit_cuda"]

_ARGTYPES = {
    "entropy_exit_argmax_bf16": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
    "entropy_exit_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    + [ctypes.c_float, ctypes.c_void_p],
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
        1, b, v, float(math.log(v)),
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
        idx.data_ptr(), k, b, v, float(math.log(v)),
        torch.cuda.current_stream(logits.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"entropy_exit kernel launch failed: cudaError {err}")
    return h, flag, idx
