"""Mamba2 (SSD, state-space duality) block [arXiv:2405.21060] — counterpart
of ``repro.models.mamba``.

Block structure (Mamba2):
    in_proj -> [z | xBC | dt]; causal depthwise conv over xBC;
    SSD(x * dt, A * dt, B, C) + D skip; RMSNorm(y * silu(z)); out_proj.

Prefill runs the SSD scan over the prompt, decode the O(1) recurrent step
on the cached state.  State cache (fp32 whatever the compute dtype, as in
the reference):
    conv: (B, W-1, conv_dim)  last raw inputs of the depthwise conv window
    ssm:  (B, H, P, N)        the SSM state
    length: () int32

What the port changes: the state is updated **in place** (the reference
returns a new state); under ``use_kernels`` the decode step is the Hopper
``ssd_update`` kernel, which reads and writes its rows of the resident
state directly, and an admission prefill (which starts from a zero state)
is the Hopper ``ssd_scan`` kernel.  A prefill that starts from a given
state (``h0``) runs the plain chunked scan :func:`ssd_chunked`.
Out-of-bounds sentinel rows (``rows[i] >= Bc``) clamp their reads and drop
their writes, as the reference's clamped gathers and ``mode="drop"``
scatters do.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.attention import PaddedPrompt, _write_slots, plan_rows, write_row
from repro_torch.models.layers import dense, rmsnorm, silu, truncated_normal_
from repro_torch.sharding.ctx import is_dtensor, local_rows, merge_dims

__all__ = [
    "init_ssm_state",
    "mamba_apply",
    "mamba_init",
    "ssd_chunked",
    "ssd_step",
]


def _dims(cfg: ModelConfig):
    inner = cfg.ssm_inner
    h = cfg.ssm_num_heads or inner // cfg.ssm_head_dim
    p = inner // h
    n = cfg.ssm_state_dim
    g = cfg.ssm_num_groups
    conv_dim = inner + 2 * g * n
    return inner, h, p, n, g, conv_dim


def mamba_init(cfg: ModelConfig, n_layers: int, generator: torch.Generator,
               device) -> dict:
    """Stacked (n_layers, ...) block params drawn from ``generator``, with
    the reference's distributions: fan-in truncated normals for the
    projections, A log-uniform in [1, 16), dt_bias the inverse softplus of
    a log-uniform dt in [1e-3, 1e-1], conv_w 0.1 N(0, 1), D = 1."""
    inner, h, _p, _n, _g, conv_dim = _dims(cfg)
    d, n = cfg.d_model, n_layers

    def proj(d_in, d_out):
        t = torch.empty((n, d_in, d_out), device=device)
        return truncated_normal_(t, generator, d_in ** -0.5)

    def log_uniform(lo, hi):
        t = torch.empty((n, h), device=device)
        return torch.exp(t.uniform_(math.log(lo), math.log(hi),
                                    generator=generator))

    w_z, w_xbc, w_dt = proj(d, inner), proj(d, conv_dim), proj(d, h)
    conv_w = torch.randn((n, cfg.ssm_conv_width, conv_dim),
                         generator=generator, device=device).mul_(0.1)
    a = log_uniform(1.0, 16.0)
    dt = log_uniform(1e-3, 1e-1)
    return {
        "w_z": w_z,
        "w_xbc": w_xbc,
        "w_dt": w_dt,
        "conv_w": conv_w,
        "conv_b": torch.zeros((n, conv_dim), device=device),
        "A_log": torch.log(a),
        "D": torch.ones((n, h), device=device),
        "dt_bias": torch.log(torch.expm1(dt)),
        "norm_scale": torch.ones((n, inner), device=device),
        "out_proj": proj(inner, d),
    }


def init_ssm_state(batch: int, cfg: ModelConfig, device) -> dict:
    """Zero conv window and SSM state, both fp32."""
    inner, h, p, n, g, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim),
                            device=device),
        "ssm": torch.zeros((batch, h, p, n), device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., L) -> (..., L, L) with out[i, j] = sum_{k=j+1..i} a_k (i >= j),
    -inf above the diagonal.  exp() of this is the decay matrix."""
    l = a.shape[-1]
    c = torch.cumsum(a, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(
    x: torch.Tensor,  # (B, L, H, P) already multiplied by dt
    a: torch.Tensor,  # (B, L, H) log-decay per step (dt * A, negative)
    b_mat: torch.Tensor,  # (B, L, G, N)
    c_mat: torch.Tensor,  # (B, L, G, N)
    chunk: int,
    h0: torch.Tensor | None = None,  # (B, H, P, N) initial state
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, fp32.  Returns (y (B, L, H, P), final state
    (B, H, P, N))."""
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    pad = (-l) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
    nc = x.shape[1] // chunk
    rep = h // g  # heads per B/C group

    xc = x.reshape(bsz, nc, chunk, h, p).float()
    ac = a.reshape(bsz, nc, chunk, h).float()
    bh = b_mat.reshape(bsz, nc, chunk, g, n).float().repeat_interleave(rep, dim=3)
    ch = c_mat.reshape(bsz, nc, chunk, g, n).float().repeat_interleave(rep, dim=3)

    # Intra-chunk (diagonal blocks): Y = (C B^T * decay) X
    lmat = torch.exp(_segsum(ac.permute(0, 1, 3, 2)))  # (B, nc, H, L, L)
    scores = torch.einsum("bclhn,bcshn->bchls", ch, bh)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * lmat, xc)

    # Chunk-final states: sum_s exp(sum_{k>s} a) B_s x_s
    a_cum = torch.cumsum(ac, dim=2)  # (B, nc, L, H)
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", bh, decay_to_end, xc)

    # Inter-chunk recurrence over chunk states; keep the state entering
    # each chunk.
    chunk_decay = torch.exp(a_cum[:, :, -1, :])  # (B, nc, H)
    h_prev = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
              if h0 is None else h0.float())
    enter = []
    for c in range(nc):
        enter.append(h_prev)
        h_prev = h_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    h_enter = torch.stack(enter, dim=1)  # (B, nc, H, P, N)

    # Off-diagonal contribution: C_t decay(t) h_enter
    in_decay = torch.exp(a_cum)
    y_off = torch.einsum("bclhn,bclh,bchpn->bclhp", ch, in_decay, h_enter)

    y = (y_diag + y_off).reshape(bsz, nc * chunk, h, p)[:, :l]
    return y, h_prev


def ssd_step(
    h_state: torch.Tensor,  # (B, H, P, N)
    x: torch.Tensor,  # (B, H, P) dt-scaled input
    a: torch.Tensor,  # (B, H) dt * A (negative)
    b_vec: torch.Tensor,  # (B, G, N)
    c_vec: torch.Tensor,  # (B, G, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step: h' = e^a h + x (x) B ; y = h' . C (fp32)."""
    rep = h_state.shape[1] // b_vec.shape[1]
    bh = b_vec.float().repeat_interleave(rep, dim=1)
    ch = c_vec.float().repeat_interleave(rep, dim=1)
    h_new = h_state * torch.exp(a)[..., None, None] + torch.einsum(
        "bhp,bhn->bhpn", x.float(), bh)
    y = torch.einsum("bhpn,bhn->bhp", h_new, ch)
    return y, h_new


def _ssd_step_local(h_state, x, a, b_vec, c_vec):
    """:func:`ssd_step` on a DTensor state (a sharded segment), on each
    rank's shard: the step is independent per (row, head), but its einsums
    flatten the batch with the heads, which DTensor (torch 2.11) cannot do
    with both sharded.  Every operand takes the state's row and head (or
    head-dim) shards, B and C this rank's heads' groups."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh, pl = h_state.device_mesh, h_state.placements

    def upto(n):  # the state's shards of the first n dims, the rest whole
        return [q if isinstance(q, Shard) and q.dim < n else Replicate() for q in pl]

    h_loc = h_state.to_local()
    _, h0 = local_rows(h_state, 1)
    rep = h_state.shape[1] // b_vec.shape[1]
    heads = (h0 + torch.arange(h_loc.shape[1], device=h_loc.device)) // rep
    b_loc, c_loc = (t.redistribute(mesh, upto(1)).to_local()[:, heads] for t in (b_vec, c_vec))
    y, h_new = ssd_step(h_loc, x.redistribute(mesh, upto(3)).to_local(),
                        a.redistribute(mesh, upto(2)).to_local(), b_loc, c_loc)
    return (DTensor.from_local(y, mesh, upto(3), run_check=False),
            DTensor.from_local(h_new, mesh, pl, run_check=False))


def _scatter_rows(buf: torch.Tensor, rows: torch.Tensor,
                  values: torch.Tensor) -> None:
    """``buf[rows[i]] = values[i]`` in place, sentinel rows (>= Bc)
    dropped: the staged, sync-free scatter of the KV cache writes
    (``attention._write_slots``) on a one-slot view of each row."""
    bc, n = buf.shape[0], values.shape[0]
    _write_slots(buf.view(bc, 1, -1), rows,
                 torch.zeros(n, dtype=torch.long, device=buf.device),
                 values.reshape(n, -1))


def mamba_apply(
    params: dict,
    x: torch.Tensor,  # (B, S, d_model)
    cfg: ModelConfig,
    state: dict | None = None,
    *,
    rows=None,
    use_kernels: bool = False,
) -> tuple[torch.Tensor, dict | None]:
    """One Mamba2 mixer.  Returns (output, state); ``state`` is updated in
    place.

      * ``state=None``: the chunked scan over x, no state;
      * state, S > 1, no ``rows``: prefill from the state's SSM contents
        (the plain chunked scan with ``h0``), writing the conv window, the
        final state and ``length += S``;
      * state, S > 1, ``rows`` (a host-side admission plan): the prompts
        start from a fresh zero state — exactly a solo prefill — and their
        conv windows and final states land in rows ``rows`` (sentinels
        dropped on the host); ``length`` is untouched.  Under
        ``use_kernels`` the scan is the Hopper ``ssd_scan`` kernel.  Under
        a device-side :class:`~repro_torch.models.attention.PaddedPrompt`
        the one prompt's pad positions carry dt = 0, so they leave the
        state as the last real position left it, and the conv window is
        gathered at the real length on the device;
      * state, S == 1: the decode step, ``length += 1``.  ``rows`` (a
        device tensor) maps the compacted sub-batch onto state rows.  Under
        ``use_kernels`` the step is the Hopper ``ssd_update`` kernel,
        updating its rows of the resident state in place (a sentinel
        row's output is zero there)."""
    inner, h, p, n, g, conv_dim = _dims(cfg)
    bsz, s, _ = x.shape
    dtype = x.dtype
    w = cfg.ssm_conv_width

    z = dense(params["w_z"], x, dtype)
    xbc = dense(params["w_xbc"], x, dtype)
    dt_raw = dense(params["w_dt"], x, dtype)  # (B, S, H)
    # The reference casts the conv weights to the compute dtype and sums
    # the W products at fp32 before one rounding.
    conv_w = params["conv_w"].to(dtype).float()
    conv_b = params["conv_b"].to(dtype)
    decode = state is not None and s == 1
    if decode:
        bc = state["ssm"].shape[0]
        prev = (state["conv"] if rows is None
                else state["conv"][rows.long().clamp(max=bc - 1)])
        conv_in = torch.cat([prev.to(dtype), xbc], dim=1)  # (B, W, C)
        conv = (conv_in.float() * conv_w).sum(dim=1)[:, None]
    else:
        xbc_pad = F.pad(xbc, (0, 0, w - 1, 0))
        windows = torch.stack([xbc_pad[:, i:i + s] for i in range(w)], dim=2)
        conv = (windows.float() * conv_w).sum(dim=2)  # (B, S, C)
    xbc_act = silu(conv.to(dtype) + conv_b)

    xs = xbc_act[..., :inner].reshape(bsz, s, h, p)
    b_mat = xbc_act[..., inner:inner + g * n].reshape(bsz, s, g, n)
    c_mat = xbc_act[..., inner + g * n:].reshape(bsz, s, g, n)

    v = dt_raw.float() + params["dt_bias"]
    dt = torch.logaddexp(v, torch.zeros_like(v))  # jax.nn.softplus
    if isinstance(rows, PaddedPrompt):
        # Pad positions: x * dt = 0 and A * dt = 0, a step that keeps the state.
        real = torch.arange(s, device=x.device) < rows.length
        dt = torch.where(real[None, :, None], dt, 0.0)
    a_neg = -torch.exp(params["A_log"])  # (H,)
    x_dt = xs.float() * dt[..., None]
    a_dt = dt * a_neg  # (B, S, H)

    if decode:
        if use_kernels:
            y1 = kernel_ops.ssd_update(state["ssm"], x_dt[:, 0], a_dt[:, 0],
                                       b_mat[:, 0], c_mat[:, 0], rows)
            if rows is not None:
                # A sentinel row reads state row Bc - 1 while that row's own
                # update may be writing it in the same launch: its output,
                # discarded by the caller, is zeroed so that the step stays
                # a function of its inputs (bitwise from run to run).
                y1 = torch.where((rows < bc)[:, None, None], y1, 0.0)
        else:
            h_prev = (state["ssm"] if rows is None
                      else state["ssm"][rows.long().clamp(max=bc - 1)])
            step = _ssd_step_local if is_dtensor(h_prev) else ssd_step
            y1, h_new = step(h_prev, x_dt[:, 0], a_dt[:, 0], b_mat[:, 0], c_mat[:, 0])
            if rows is None:
                state["ssm"].copy_(h_new)
            else:
                _scatter_rows(state["ssm"], rows, h_new)
        new_conv = conv_in[:, 1:]
        if rows is None:
            state["conv"].copy_(new_conv)
        else:
            _scatter_rows(state["conv"], rows, new_conv)
        state["length"] += 1
        y = y1[:, None]
    else:
        h0 = state["ssm"] if state is not None and rows is None else None
        if use_kernels and h0 is None:
            y, h_last = kernel_ops.ssd_scan(x_dt, a_dt, b_mat, c_mat,
                                            chunk=cfg.ssm_chunk)
        else:
            y, h_last = ssd_chunked(x_dt, a_dt, b_mat, c_mat, cfg.ssm_chunk,
                                    h0=h0)
        if isinstance(rows, PaddedPrompt):
            # The raw xBC of the last W-1 real positions, zeros before 0.
            at = rows.length - (w - 1) + torch.arange(w - 1, device=x.device)
            tail = torch.where((at >= 0)[None, :, None],
                               xbc.index_select(1, at.clamp(min=0)), 0.0)
            write_row(state["conv"], rows.row, tail)
            write_row(state["ssm"], rows.row, h_last)
        elif state is not None:
            # Raw (pre-conv) xBC inputs of the last W-1 positions seed the
            # decode-time conv window; left-pad a shorter sequence.
            conv_tail = F.pad(xbc, (0, 0, max(0, (w - 1) - s), 0))[:, -(w - 1):]
            if rows is None:
                state["conv"].copy_(conv_tail)
                state["ssm"].copy_(h_last)
                state["length"] += s
            else:
                plan = plan_rows(rows, state["ssm"].shape[0], x.device)
                if plan is not None:
                    sel, tgt = plan
                    state["conv"][tgt] = conv_tail[sel].to(state["conv"].dtype)
                    state["ssm"][tgt] = h_last[sel]

    y = y + xs.float() * params["D"][:, None]
    y = merge_dims(y, 2).to(dtype)
    y = rmsnorm({"scale": params["norm_scale"]}, y * silu(z))
    return dense(params["out_proj"], y, dtype), state

