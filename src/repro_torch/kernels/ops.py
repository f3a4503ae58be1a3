"""Dispatch layer of the port's serving-path kernels.

The model and serving code call these wrappers when ``use_kernels`` is on:

  * :func:`flash_decode` — single-token GQA decode attention reading the
    compacted survivor rows straight out of the full-batch resident KV
    cache through a row map (``models.attention.attn_apply`` decode);
  * :func:`entropy_exit_argmax_heads` — the fused BranchyNet exit decision
    of K stacked branch heads in one launch (``serving.tiers``);
  * :func:`entropy_exit_argmax` — the single-head form, the same kernel's
    K = 1 launch (``TierExecutor(batched_heads=False)``);
  * :func:`entropy_exit` — entropy and flag without the token, the same
    kernel with the argmax compiled out (no serving caller: calibration
    sweeps, as in the reference);
  * :func:`ssd_update` — one Mamba2 SSD decode step against the resident
    state, updated in place through the same ``rows`` map
    (``models.mamba.mamba_apply`` decode);
  * :func:`ssd_scan` — the SSD scan of admitted prompts from a zero state
    (``models.mamba.mamba_apply`` row-targeted prefill).

A wrapper given CPU tensors runs the plain PyTorch version
(:mod:`repro_torch.kernels.ref`); given CUDA tensors it launches the
hand-written Hopper kernel or raises — there is no fallback.  Each wrapper
adds one to ``launches[name]`` where it launches its kernel and nowhere
else, so a run can show that its main path went through the kernels.
A CUDA-graph capture runs nothing: the serving runtime counts the
launches made while it captures as recorded (:func:`recording`), and each
replay of that graph adds them (:func:`add_launches`), so the counts stay
what the card ran.

``use_kernels`` resolution (:func:`resolve_use_kernels`): None = kernels on
a CUDA device, plain versions on the CPU; asking for the kernels (True, or
None on a CUDA card) anywhere but a CUDA sm_90 device raises; False =
plain versions everywhere.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import ref

__all__ = [
    "add_launches",
    "entropy_exit",
    "entropy_exit_argmax",
    "entropy_exit_argmax_heads",
    "flash_decode",
    "launches",
    "on_cuda_sm90",
    "recording",
    "reset_launches",
    "resolve_device",
    "resolve_use_kernels",
    "ssd_scan",
    "ssd_update",
]

#: Kernel launches per wrapper since the last :func:`reset_launches`.
launches: dict[str, int] = {
    "flash_decode": 0,
    "entropy_exit_argmax_heads": 0,
    "entropy_exit_argmax": 0,
    "entropy_exit": 0,
    "ssd_update": 0,
    "ssd_scan": 0,
}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def recording():
    """Launches made inside are recorded, not run (a CUDA-graph capture):
    yields a dict that holds them per wrapper on exit, and leaves
    ``launches`` as it was."""
    before = dict(launches)
    recorded: dict[str, int] = {}
    try:
        yield recorded
    finally:
        for name, n in before.items():
            recorded[name] = launches[name] - n
            launches[name] = n


def add_launches(recorded: dict[str, int]) -> None:
    """A replay of a captured graph ran the launches its capture recorded."""
    for name, n in recorded.items():
        launches[name] += n


def on_cuda_sm90(device=None) -> bool:
    """True when ``device`` (default: the current CUDA device) is a CUDA
    device of compute capability 9.0 (Hopper)."""
    if not torch.cuda.is_available():
        return False
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type != "cuda":
        return False
    return torch.cuda.get_device_capability(dev) == (9, 0)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the current CUDA device when
    ``device`` is None, else ``device``.  Raises when CUDA is asked for
    (explicitly or by default) and none is present — pass ``device="cpu"``
    to run the plain versions on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run the port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} asked for but CUDA is not available")
    return dev


def resolve_use_kernels(flag: bool | None, device, *, sharded: bool = False) -> bool:
    """The ``use_kernels`` tri-state for an entry point on ``device``:
    None = the kernels on a CUDA device, the plain versions on the CPU.
    The kernels are built for sm_90a only, so asking for them on anything
    but a CUDA sm_90 device — by True, or by None on another CUDA card —
    raises; ``False`` is the one way to run the plain versions on a card.

    ``sharded=True`` (a mesh-sharded tier segment) always resolves to the
    plain versions, as the reference does: the kernels are single-device
    programs and must not see a mesh-global batch.  Handing them a sharded
    operand would either fail or gather the whole sharded KV cache onto
    one device."""
    if sharded:
        return False
    dev = torch.device(device)
    if flag is False or (flag is None and dev.type != "cuda"):
        return False
    if not on_cuda_sm90(dev):
        raise RuntimeError(
            f"the Hopper kernels need a CUDA sm_90 device, got {dev}; "
            "pass use_kernels=False to run the plain versions")
    return True


def entropy_exit_argmax_heads(logits: torch.Tensor, thresholds):
    """(K, B, V) stacked branch-head logits -> (normalized entropy (K, B),
    exit flags (K, B), argmax token (K, B) int32); ``thresholds`` is a
    scalar (every head) or (K,)."""
    if not logits.is_cuda:
        return ref.entropy_exit_argmax_heads_ref(logits, thresholds)
    from repro_torch.kernels.entropy_exit import entropy_exit_argmax_heads_cuda

    out = entropy_exit_argmax_heads_cuda(logits, thresholds)
    launches["entropy_exit_argmax_heads"] += 1
    return out


def entropy_exit_argmax(logits: torch.Tensor, threshold):
    """Single-head exit decision: (B, V) -> (entropy (B,), flag (B,), token
    (B,) int32) — the multi-head kernel's K = 1 launch."""
    if not logits.is_cuda:
        return ref.entropy_exit_argmax_ref(logits, threshold)
    from repro_torch.kernels.entropy_exit import entropy_exit_argmax_heads_cuda

    h, flag, idx = entropy_exit_argmax_heads_cuda(logits[None], threshold)
    launches["entropy_exit_argmax"] += 1
    return h[0], flag[0], idx[0]


def flash_decode(q, k, v, k_pos, q_pos, rows=None, *, window: int = 0):
    """Single-token GQA decode attention against a (ring) KV cache; ``rows``
    maps a compacted survivor sub-batch onto cache rows."""
    if not q.is_cuda:
        return ref.flash_decode_ref(q, k, v, k_pos, q_pos, rows, window)
    from repro_torch.kernels.flash_decode import flash_decode_cuda

    out = flash_decode_cuda(q, k, v, k_pos, q_pos, rows, window=window)
    launches["flash_decode"] += 1
    return out


def entropy_exit(logits: torch.Tensor, threshold):
    """(B, V) logits -> (normalized entropy (B,), exit flags (B,))."""
    if not logits.is_cuda:
        return ref.entropy_exit_ref(logits, threshold)
    from repro_torch.kernels.entropy_exit import entropy_exit_cuda

    out = entropy_exit_cuda(logits, threshold)
    launches["entropy_exit"] += 1
    return out


def ssd_update(h_state, x, a, b_vec, c_vec, rows=None):
    """One SSD decode step: row i of the sub-batch reads state row
    ``rows[i]`` (clamped) and writes its new state back there in place
    (rows >= Bc drop).  Returns y (B, H, P) fp32."""
    if not h_state.is_cuda:
        return ref.ssd_update_ref(h_state, x, a, b_vec, c_vec, rows)
    from repro_torch.kernels.ssd_scan import ssd_update_cuda

    out = ssd_update_cuda(h_state, x, a, b_vec, c_vec, rows)
    launches["ssd_update"] += 1
    return out


def ssd_scan(x, a, b_mat, c_mat, *, chunk: int = 64):
    """SSD scan from a zero state: (y (B, L, H, P), final state
    (B, H, P, N)), fp32; B and C per group, (B, L, G, N)."""
    if not x.is_cuda:
        return ref.ssd_scan_ref(x, a, b_mat, c_mat)
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    out = ssd_scan_cuda(x, a, b_mat, c_mat, chunk=chunk)
    launches["ssd_scan"] += 1
    return out
