"""Single-token GQA decode attention: the Hopper kernel's launcher.

Replaces ``repro/kernels/flash_decode.py::flash_decode_pallas``.  The
kernel is ``csrc/flash_decode.cu`` (CUDA C++, sm_90a, plain C interface;
written in CUDA rather than Triton because D = 96 is not a power of two);
its source note says what bounds it on the H100 and how the design answers
that.  The kernel splits the cache's C slots into :func:`split_plan`'s
fixed splits, one block per (query row, kv head, split), reads only the
valid slots of each, and merges the splits' fp32 partials in split order
in a second kernel launched by the same C call; this module allocates the
partials' workspace.  The plain PyTorch version is
:func:`repro_torch.kernels.ref.flash_decode_ref`;
:mod:`repro_torch.kernels.ops` dispatches between the two by the device
of the query and counts launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import load

__all__ = ["SPLIT", "flash_decode_cuda", "split_plan"]

_GROUPS = (1, 2, 4, 8)
#: Cache slots per split (``kSplit`` in ``csrc/flash_decode.cu``).
SPLIT = 512
_lib = None


def split_plan(c: int) -> tuple[int, int]:
    """(slots per split, number of splits) for a cache of ``c`` slots.  It
    depends on ``c`` only — never on the batch, the row map or the data —
    so each row's output is a function of that row's inputs alone."""
    return SPLIT, -(-c // SPLIT)


def _fn():
    global _lib
    if _lib is None:
        f = load("flash_decode").flash_decode_bf16
        f.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
        _lib = f
    return _lib


def _int_vec(x, n: int, device, name: str) -> torch.Tensor:
    t = torch.as_tensor(x, device=device)
    if t.dim() > 1 or t.numel() not in (1, n):
        raise ValueError(f"{name} must be a scalar or ({n},)")
    return t.to(torch.int32).expand(n).contiguous()


def flash_decode_cuda(q, k, v, k_pos, q_pos, rows=None, *, window: int = 0):
    """Launch the kernel.  q (B, H, D) bf16; k, v (Bc, C, Kh, D) bf16;
    k_pos (C,) or (Bc, C) int32; q_pos () or (B,); rows (B,) or None.
    Returns (B, H, D) bf16, enqueued on the current stream (one C call:
    the split kernel, then the merge kernel)."""
    if not q.is_cuda:
        raise ValueError("flash_decode kernel needs CUDA tensors")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device:
            raise ValueError(f"{name} must be bfloat16 on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 4:
            raise ValueError(f"{name} must be contiguous and 4-byte aligned")
    b, h, d = q.shape
    bc, c, kh, dk = k.shape
    if dk != d or h % kh or h // kh not in _GROUPS or d % 2 or d > 256:
        raise ValueError(
            f"unsupported head layout: H={h}, Kh={kh}, D={d} (G = H/Kh in "
            f"{_GROUPS}, D even and <= 256)")
    if k_pos.dim() == 1:
        k_pos = k_pos.expand(bc, c)
    if tuple(k_pos.shape) != (bc, c):
        raise ValueError(f"k_pos must be ({c},) or ({bc}, {c})")
    k_pos = k_pos.to(torch.int32).contiguous()
    qp = _int_vec(q_pos, b, q.device, "q_pos")
    rw = (torch.arange(b, dtype=torch.int32, device=q.device) if rows is None
          else _int_vec(rows, b, q.device, "rows"))
    out = torch.empty_like(q)
    _, splits = split_plan(c)
    # Per (row, kv head, split, query head): acc (D floats), then (m, l).
    ws = torch.empty(b * kh * splits * h // kh * (d + 2), dtype=torch.float32,
                     device=q.device)
    err = _fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_pos.data_ptr(),
        qp.data_ptr(), rw.data_ptr(), out.data_ptr(), ws.data_ptr(),
        b, bc, c, kh, h // kh, d, int(window), 1.0 / math.sqrt(d), splits,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: cudaError {err}")
    return out
