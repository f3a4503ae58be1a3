"""Mamba2 / SSD state-space kernels: the Hopper launchers.

Replaces ``repro/kernels/ssd_scan.py``'s two Pallas kernels:

  * :func:`ssd_update_cuda` — ``ssd_update_pallas``, one recurrent decode
    step against the full-batch resident state.  Unlike the TPU kernel,
    which returns the new state rows densely for its caller to scatter,
    this one updates the resident state **in place** (sentinel rows drop
    their write), so each live row is read and written once;
  * :func:`ssd_scan_cuda` — ``ssd_scan_pallas``, the scan of a whole
    prompt from a zero state, with B and C taken per group
    (``(B, L, G, N)``, ``rep = H / G``) as the model produces them.  Like
    the TPU kernel it computes the chunked form, 64-token chunks as
    tensor-core products (3xTF32 where an operand is not exact in TF32).

The kernels are ``csrc/ssd_scan.cu`` (CUDA C++, sm_90a, plain C
interface); its source note says what bounds each on the H100 and how
the design answers that.  The plain PyTorch versions are
:func:`repro_torch.kernels.ref.ssd_update_ref` and
:func:`~repro_torch.kernels.ref.ssd_scan_ref`;
:mod:`repro_torch.kernels.ops` dispatches by device and counts launches.

B and C are read where the model leaves them, as slices of its xBC
activations: the ``(G, N)`` block of each token must be contiguous, with
one uniform stride between tokens (checked here).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load

__all__ = ["SCAN_CHUNK", "ssd_scan_cuda", "ssd_update_cuda"]

_SCAN_N = (16, 32, 64, 128)
#: The one chunk length the scan kernel computes (both full configs'
#: ``ssm_chunk``).
SCAN_CHUNK = 64
_ARGTYPES = {
    "ssd_update": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
    "ssd_scan": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
}
_fns: dict = {}


def _fn(name: str):
    f = _fns.get(name)
    if f is None:
        f = getattr(load("ssd_scan"), name)
        f.argtypes = _ARGTYPES[name]
        f.restype = ctypes.c_int
        _fns[name] = f
    return f


def _f32(name: str, t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.float32 or t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous float32 on {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")


def _token_stride(name: str, t: torch.Tensor, lead, g: int, n: int,
                  device) -> int:
    """Elements between consecutive tokens of a (*lead, G, N) B or C whose
    (G, N) blocks are contiguous; raises on any other layout."""
    if tuple(t.shape) != (*lead, g, n):
        raise ValueError(f"{name} must be {(*lead, g, n)}, got {tuple(t.shape)}")
    if t.dtype not in (torch.float32, torch.bfloat16) or t.device != device:
        raise ValueError(f"{name} must be float32 or bfloat16 on {device}")
    if t.stride(-1) != 1 or (g > 1 and t.stride(-2) != n):
        raise ValueError(f"{name}: each token's (G, N) block must be contiguous")
    stride, span = None, None
    for size, st in reversed(list(zip(t.shape[:-2], t.stride()[:-2]))):
        if size == 1:
            continue
        if stride is None:
            stride = st
        elif st != span:
            raise ValueError(f"{name}: tokens must be one uniform stride apart")
        span = st * size
    return g * n if stride is None else stride


def ssd_update_cuda(h_state, x, a, b_vec, c_vec, rows=None) -> torch.Tensor:
    """Launch one SSD decode step.  h_state (Bc, H, P, N) fp32 contiguous,
    updated in place; x (B, H, P), a (B, H) fp32; b_vec, c_vec (B, G, N)
    fp32 or bf16 (same dtype); rows (B,) or None (= arange(B)), entries
    >= Bc drop their write.  Returns y (B, H, P) fp32, enqueued on the
    current stream."""
    dev = h_state.device
    if not h_state.is_cuda:
        raise ValueError("ssd_update kernel needs CUDA tensors")
    if (h_state.dim() != 4 or h_state.dtype != torch.float32
            or not h_state.is_contiguous() or h_state.data_ptr() % 16):
        raise ValueError("h_state must be a contiguous, 16-byte aligned "
                         "(Bc, H, P, N) float32 tensor")
    bc, h, p, n = h_state.shape
    b = x.shape[0]
    g = b_vec.shape[1] if b_vec.dim() == 3 else 0
    if n < 4 or n > 128 or n & (n - 1) or g < 1 or h % g:
        raise ValueError(f"unsupported SSD layout H={h}, N={n}, G={g} "
                         "(N a power of two in [4, 128], G divides H)")
    _f32("x", x, (b, h, p), dev)
    _f32("a", a, (b, h), dev)
    sbc = _token_stride("b_vec", b_vec, (b,), g, n, dev)
    if (_token_stride("c_vec", c_vec, (b,), g, n, dev) != sbc
            or c_vec.dtype != b_vec.dtype):
        raise ValueError("b_vec and c_vec must share dtype and layout")
    rw = (torch.arange(b, dtype=torch.int32, device=dev) if rows is None
          else torch.as_tensor(rows, device=dev).to(torch.int32).reshape(b))
    y = torch.empty((b, h, p), dtype=torch.float32, device=dev)
    err = _fn("ssd_update")(
        h_state.data_ptr(), x.data_ptr(), a.data_ptr(), b_vec.data_ptr(),
        c_vec.data_ptr(), rw.data_ptr(), y.data_ptr(),
        b, bc, h, p, n, g, sbc, int(b_vec.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_update kernel launch failed: cudaError {err}")
    return y


def ssd_scan_cuda(x, a, b_mat, c_mat, *, chunk: int = 64
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the scan from a zero state.  x (B, L, H, P), a (B, L, H)
    fp32 contiguous; b_mat, c_mat (B, L, G, N) fp32 or bf16; ``chunk``
    must be :data:`SCAN_CHUNK` (the kernel's chunked form).  Returns
    (y (B, L, H, P) fp32, final state (B, H, P, N) fp32), enqueued on the
    current stream."""
    dev = x.device
    if not x.is_cuda:
        raise ValueError("ssd_scan kernel needs CUDA tensors")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, L, H, P), got {tuple(x.shape)}")
    bsz, l, h, p = x.shape
    g, n = (b_mat.shape[2], b_mat.shape[3]) if b_mat.dim() == 4 else (0, 0)
    if n not in _SCAN_N or g < 1 or h % g or p % 8 or not 8 <= p <= 256:
        raise ValueError(f"unsupported SSD layout H={h}, P={p}, N={n}, G={g} "
                         f"(N in {_SCAN_N}, P a multiple of 8 up to 256, "
                         "G divides H)")
    if chunk != SCAN_CHUNK:
        raise ValueError(f"the ssd_scan kernel computes chunks of {SCAN_CHUNK} "
                         f"tokens, got chunk={chunk}")
    _f32("x", x, (bsz, l, h, p), dev)
    _f32("a", a, (bsz, l, h), dev)
    sbc = _token_stride("b_mat", b_mat, (bsz, l), g, n, dev)
    if (_token_stride("c_mat", c_mat, (bsz, l), g, n, dev) != sbc
            or c_mat.dtype != b_mat.dtype):
        raise ValueError("b_mat and c_mat must share dtype and layout")
    y = torch.empty_like(x)
    h_out = torch.empty((bsz, h, p, n), dtype=torch.float32, device=dev)
    err = _fn("ssd_scan")(
        x.data_ptr(), a.data_ptr(), b_mat.data_ptr(), c_mat.data_ptr(),
        y.data_ptr(), h_out.data_ptr(), bsz, l, h, p, n, g, sbc, chunk,
        int(b_mat.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {err} "
                           "(1: a layout whose block needs over 227 KB of "
                           "shared memory)")
    return y, h_out
