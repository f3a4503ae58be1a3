"""K-tier decode runtime — counterpart of ``repro.serving.tiers``.

One decode step crosses the tiers of a plan (edge -> cloud for the paper's
K = 2).  Every tier runs a contiguous trunk segment, evaluates the side
branches strictly inside it, and ships its survivors on.  Branch placement
follows the paper (a branch at a cut is discarded; the final tier of a
K >= 2 plan evaluates no side branch).

Survivor compaction (``compaction="bucketed"``, the default): every
downstream tier

  1. **compacts** — a stable device-side ``argsort`` of the exit mask puts
     survivors first, and the leading ``bucket`` rows (survivors, then
     already-exited padding rows) form a dense sub-batch.  KV caches stay
     full-batch resident: the sub-batch reads and writes its rows in place
     through the ``rows`` map, and padding rows carry an out-of-bounds
     sentinel so their cache writes drop;
  2. **runs** its layers, branches and (last tier) head on the sub-batch;
  3. **scatters** tokens, exit masks, entropies and logits back to batch
     order, so the step ends in exactly ONE device-to-host fetch.

``compaction="off"`` runs every tier on the full batch, masked.  Buckets
come from :func:`repro_torch.core.multitier.bucket_ladder`, planned on the
host from a windowed max of earlier steps' survivor counts (no extra sync);
if a step's survivors overflow the planned bucket, the step is re-run with
measured buckets (``overflow_retries``), results always exact.

Exit heads: with ``batched_heads=True`` (the default) a tier's kept
branches evaluate as ONE stacked (K, B, D) projection and ONE exit
decision — the Hopper ``entropy_exit_argmax_heads`` kernel under
``use_kernels`` — while ``False`` evaluates them one head at a time (the
single-head kernel).  Precedence (``take = flag & ~exited``, in layer
order) is applied after the decision either way, so both give the same
tokens and masks.

What the port changes, and why:

  * **CUDA graphs in place of jit.**  A segment function is cached per
    ``(spec, bucket)`` as the reference jits one (:class:`SegmentFn`; the
    key is ``((layer_lo, layer_hi, branches, head, probe, probe_m),
    bucket)``), and ``install`` reuses every entry whose key is unchanged.
    A variant is built per argument signature (the shape of ``pos``, a
    lock-step scalar or a per-row vector; the batch; the caches' layout),
    as jit traces per argument shapes, and ``trace_counts`` counts the
    builds per key.  On the CPU, or with ``graphs=False``, a variant is the
    plain eager call.  With graphs (the default on CUDA) a variant is one
    ``torch.cuda.CUDAGraph`` over its own static inputs (``x``, positions,
    ``exited``, ``chosen`` and the sampled probe's rows), bound to the
    caches' addresses (they update in place, so they are static): a key's
    first use runs eagerly as the real step on the capture stream (this
    also loads the kernels and settles cuBLAS), then the same call is
    captured, which runs nothing; every later use copies its inputs into
    the buffers and replays.  Caches at other addresses re-capture (one
    graph per variant is kept).  A capture that fails raises; there is no
    eager fallback.  Graphs and their memory pools belong to the executor.
  * **Output lifetime under graphs.**  A replay rewrites its static
    outputs.  Inside a step each segment's outputs (hidden, exit mask,
    chosen tokens) are copied into the next segment's own input buffers
    before it replays, so a cached graph never reads another graph's
    output by address (after a swap a cached cloud graph can meet a new
    edge graph); the fetched tensors are packed before any re-run.
    ``TierStepResult.tokens_dev`` and ``last_logits`` outlive the step, so
    they are cloned where they leave it: the scheduler's next input token,
    an engine's ``last_logits`` and every other holder get their own copy.
  * **What stays eager.**  Uploads (positions, the live mask, probe rows:
    pinned memory, no sync), the bucket plan, the overflow snapshot and
    restore, the packed fetch, and admission: ``prefill_rows`` and
    ``reset_rows`` take a host-side row plan (sentinels are dropped on the
    host, ``models/attention.py::plan_rows``), so they are not captured.
    A step still makes exactly one host sync.
  * **Caches update in place** (a full-size cache is 12.9 GB).  The
    reference re-runs an overflowed step from its immutable entry caches;
    here the step first snapshots what it can write and restores it before
    a re-run: for every KV ring (trunk layers and hybrid shared-attention
    sites), per layer and row, the one slot the step writes (``pos % C``,
    or ``length % C`` in lock-step) — a few MB instead of a clone of the
    cache; for every Mamba2 layer the whole conv window and SSM state,
    which a step overwrites in every row it runs (about 320 MB at
    Zamba2-1.2B's size); and every step counter.  The snapshot is taken
    only when some planned bucket is narrower than the batch (otherwise
    nothing can overflow).  A re-run replays the measured buckets' graphs.
  * **The single fetch** packs every fetched tensor into one int32 buffer,
    so a step costs one device-to-host copy, as the reference's one
    ``device_get`` does.

Probe steps (the reference's exploration contract): ``probe_next = True``
makes the next step evaluate every ``cfg.branch_layers`` head; the extra
heads are report-only (their would-exit masks and entropies join
``branch_take`` / ``branch_entropy``), while tokens, exits, caches and
bytes are bitwise those of a normal step.  The probe heads always form a
second joint evaluation of their own (the reference folds an unsampled
probe into the plan's stack): the plan heads then keep the projection
shape of a normal step, whose GEMM a card may round differently at
another width.  ``probe_sample_frac`` < 1 evaluates them on a rotating
sample of live rows and reports the covered rows in
``TierStepResult.branch_probe_mask``.  Probe keys are cached and captured
like any other.

Not ported yet (see ROADMAP.md): mesh-sharded segments, the fault plane
and degraded steps, ``overlap="pipelined"`` and ``simulate_network``.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.multitier import bucket_for, bucket_ladder
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref
from repro_torch.models.layers import norm_apply
from repro_torch.models.model import (
    _unembed,
    branch_logits_per_head,
    branch_logits_stacked,
    compute_dtype,
    compute_params,
    embed_decode,
    hybrid_sites,
    prefill,
    run_trunk,
    trunk_layout,
)

__all__ = [
    "HopCompaction",
    "SegmentFn",
    "TierExecutor",
    "TierSegment",
    "TierStepResult",
    "TOKEN_ID_BYTES",
    "bytes_per_sequence",
    "measured_exit_probs",
    "resolve_graphs",
    "segments_for_cuts",
    "transfer_seconds",
]

#: Per-sequence payload of a hop taken before any trunk layer ran.
TOKEN_ID_BYTES = 4.0


@dataclasses.dataclass(frozen=True)
class TierSegment:
    """One tier's share of the trunk: layers ``[layer_lo, layer_hi)``
    (absolute, 0-based) and the 1-based branch points it evaluates."""

    name: str
    layer_lo: int
    layer_hi: int
    branches: tuple[int, ...] = ()

    @property
    def is_empty(self) -> bool:
        return self.layer_hi == self.layer_lo

    def spec(self, head: bool) -> tuple:
        """The segment's part of its cache key."""
        return (self.layer_lo, self.layer_hi, self.branches, head)


@dataclasses.dataclass(frozen=True)
class HopCompaction:
    """Per-hop compaction accounting: who survived, what shape ran."""

    survivors: int  # true survivors crossing the hop
    bucket: int  # sub-batch width the downstream tier ran

    @property
    def padded_waste(self) -> int:
        return self.bucket - self.survivors


def transfer_seconds(nbytes: float, uplink_bps: float | None) -> float:
    """Wall seconds to ship ``nbytes`` over a hop; an unset/zero uplink
    reports 0.0 (the hop is unaccounted, not priced: the cost model prices
    an unusable hop infinite)."""
    if not uplink_bps or uplink_bps <= 0.0:
        return 0.0
    return nbytes * 8.0 / uplink_bps


def bytes_per_sequence(cfg: ModelConfig, cut_layer: int) -> float:
    """Payload one surviving sequence ships at a cut after ``cut_layer``
    (1-based; 0 = before any trunk layer -> raw token id)."""
    if cut_layer == 0:
        return TOKEN_ID_BYTES
    return cfg.d_model * 2.0  # bf16 residual stream


def segments_for_cuts(
    cfg: ModelConfig,
    cuts: Sequence[int],
    *,
    names: Sequence[str] | None = None,
) -> tuple[TierSegment, ...]:
    """Monotone 1-based cut points ``(c_1 .. c_{K-1})`` -> K segments.
    Tier j runs layers ``(c_j, c_{j+1}]``; branches sit strictly inside a
    tier, never on the final tier of a K >= 2 plan."""
    total = sum(n for _, _, n in trunk_layout(cfg))
    bounds = (0, *(int(c) for c in cuts), total)
    if any(b > a for a, b in zip(bounds[1:], bounds[:-1])):
        raise ValueError(f"cuts must be non-decreasing in [0, {total}]: {cuts}")
    k = len(bounds) - 1
    segs = []
    for j in range(k):
        lo, hi = bounds[j], bounds[j + 1]
        if j == k - 1 and k > 1:
            brs: tuple[int, ...] = ()
        else:
            brs = tuple(
                b for b in cfg.branch_layers
                if lo < b and (b <= hi if hi == total else b < hi)
            )
        segs.append(TierSegment(names[j] if names else f"tier{j}", lo, hi, brs))
    return tuple(segs)


def resolve_graphs(flag: bool | None, device) -> bool:
    """The ``graphs`` tri-state for an executor on ``device``: None = CUDA
    graphs on a CUDA device, eager on the CPU; True off CUDA raises;
    False runs eager on the card too (the comparison baseline)."""
    dev = torch.device(device)
    if flag is None:
        return dev.type == "cuda"
    if flag and dev.type != "cuda":
        raise ValueError(f"graphs=True needs a CUDA device, got {dev}")
    return bool(flag)


@dataclasses.dataclass
class TierStepResult:
    """Everything a server needs from one decode step, fetched in one
    device-to-host copy (except the device-resident feedback tensors, which
    are the step's own: see the module doc on output lifetime).  In
    compacted mode, ``branch_entropy`` and ``last_logits`` rows of
    sequences that were never computed downstream are zero."""

    tokens: np.ndarray  # (B,) chosen token per sequence
    exited: np.ndarray  # (B,) bool — exited at some side branch
    exit_tier: np.ndarray  # (B,) int32 tier of the exit, -1 = main head
    branch_take: dict[int, np.ndarray]  # layer -> (B,) first-exit mask
    branch_entropy: dict[int, np.ndarray]  # layer -> (B,) entropy
    shipped_per_hop: tuple[int, ...]
    bytes_per_hop: tuple[float, ...]
    tokens_dev: torch.Tensor  # (B,) int32 on the device: next step's input
    last_logits: torch.Tensor  # (B, V) main-head logits on the device
    compaction: tuple[HopCompaction, ...] = ()
    live: int = 0  # sequences live at step entry
    active: np.ndarray | None = None  # the live mask the step ran with
    #: Sampled probe steps only: layer -> (B,) rows whose probed head was
    #: evaluated; the controller counts arrivals over these rows.  Empty
    #: for full probes and normal steps.
    branch_probe_mask: dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict)


def measured_exit_probs(res) -> dict[int, float]:
    """Per-branch conditional exit probability of one step (a
    :class:`TierStepResult`, or anything carrying ``tokens`` and
    ``branch_take``): exits at a branch over the live rows still alive
    when they reached it, branches in layer order.  A probe step's
    would-exit mask of a branch before a kept one can overlap the kept
    branch's exits, so each branch counts only rows still alive (on a
    normal step the masks are disjoint and this is exits / arrivals)."""
    active = getattr(res, "active", None)
    alive = (np.ones(len(res.tokens), bool) if active is None
             else np.asarray(active, bool).copy())
    out = {}
    for layer in sorted(res.branch_take):
        took = res.branch_take[layer] & alive
        n = int(alive.sum())
        out[layer] = float(took.sum()) / n if n > 0 else 0.0
        alive &= ~took
    return out


@dataclasses.dataclass(eq=False)
class SegmentFn:
    """One cached segment function, the counterpart of the reference's
    jitted ``(spec, bucket)`` callable.  ``key`` is ``((layer_lo, layer_hi,
    branches, head, probe, probe_m), bucket)``; ``variants`` maps an
    argument signature to its build (True for an eager variant, a
    :class:`_Graph` under graphs).  The executor calls it
    (:meth:`TierExecutor.call_segment`)."""

    key: tuple
    seg: TierSegment
    head: bool
    bucket: int | None
    probe: tuple[int, ...] = ()
    probe_m: int | None = None
    variants: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(eq=False)
class _Graph:
    """A captured segment: its graph, static inputs and outputs, the cache
    addresses it is bound to, and the kernel launches its capture
    recorded (each replay runs them again)."""

    binding: tuple
    graph: Any
    inputs: tuple[torch.Tensor, ...]
    out: dict
    launches: dict[str, int]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _pack(fetch: dict[str, torch.Tensor]):
    """Flatten tensors of int32 / bool / float32 into one int32 buffer."""
    parts, meta = [], []
    for key, t in fetch.items():
        flat = t.contiguous().reshape(-1)
        if t.dtype == torch.float32:
            flat = flat.view(torch.int32)
        elif t.dtype != torch.int32:
            flat = flat.to(torch.int32)
        parts.append(flat)
        meta.append((key, tuple(t.shape), t.dtype, flat.numel()))
    return torch.cat(parts), meta


def _unpack(buf: np.ndarray, meta) -> dict[str, np.ndarray]:
    out, off = {}, 0
    for key, shape, dtype, n in meta:
        a = buf[off:off + n]
        off += n
        if dtype == torch.float32:
            a = a.view(np.float32)
        elif dtype == torch.bool:
            a = a.astype(bool)
        out[key] = a.reshape(shape)
    return out


def _scatter(width: int, cols: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Zeros of ``(*values.shape[:-1], width)`` with ``values`` at columns
    ``cols`` (duplicate columns carry equal values)."""
    out = torch.zeros((*values.shape[:-1], width), dtype=values.dtype,
                      device=values.device)
    return out.index_copy_(values.dim() - 1, cols, values)


class TierExecutor:
    """Runs the K-hop decode step with survivor compaction at every hop.

    ``device``: where params, caches and every tensor of the step live
    (None = the current CUDA device; raises without one — pass "cpu" to
    run the plain versions on the CPU).  ``use_kernels``: None = the
    config's, then auto (Hopper kernels on CUDA, plain versions on the
    CPU); the kernels anywhere but CUDA sm_90 raise.  ``graphs``: None =
    CUDA graphs on CUDA, eager on the CPU (:func:`resolve_graphs`).  The
    params are held once as their compute-dtype copies
    (:func:`repro_torch.models.model.compute_params`)."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        segments: Sequence[TierSegment],
        *,
        compaction: str = "bucketed",
        use_kernels: bool | None = None,
        batched_heads: bool = True,
        hint_window: int = 8,
        bucket_headroom: float = 0.0,
        device=None,
        graphs: bool | None = None,
    ):
        if compaction not in ("bucketed", "off"):
            raise ValueError(f"unknown compaction mode: {compaction!r}")
        if hint_window < 1:
            raise ValueError(f"hint_window must be >= 1: {hint_window}")
        if bucket_headroom < 0.0:
            raise ValueError(f"bucket_headroom must be >= 0: {bucket_headroom}")
        self.cfg = cfg
        self.device = kernel_ops.resolve_device(device)
        self.use_kernels = kernel_ops.resolve_use_kernels(
            cfg.use_kernels if use_kernels is None else use_kernels,
            self.device)
        self.graphs = resolve_graphs(graphs, self.device)
        self.params = compute_params(_to_device(params, self.device),
                                     compute_dtype(cfg))
        self.compaction = compaction
        self.batched_heads = bool(batched_heads)
        self.hint_window = hint_window
        self.bucket_headroom = bucket_headroom
        #: Set to make the NEXT step a probe (see the module doc); consumed
        #: by step().
        self.probe_next = False
        #: Fraction of the batch a probe step evaluates the extra heads on.
        self.probe_sample_frac = 1.0
        self._probe_offset = 0  # rotation cursor over the live rows
        self.total_layers = sum(n for _, _, n in trunk_layout(cfg))
        self.host_syncs = 0
        self.overflow_retries = 0
        #: key -> builds (eager variants, or graph captures) of its decode
        #: segment; admission is not cached, so unlike the reference's this
        #: holds no prefill keys.
        self.trace_counts: dict[tuple, int] = {}
        #: key -> graph replays.
        self.replays: dict[tuple, int] = {}
        self._fn_cache: dict[tuple, SegmentFn] = {}
        self._stream = None  # the capture stream, made at the first capture
        self.install(segments)

    # -------------------------------------------------------------- plan
    def install(self, segments: Sequence[TierSegment]) -> None:
        """Install a new tier plan, reusing the cached function of every
        segment whose key is unchanged; survivor hints restart at full
        batch."""
        segments = tuple(segments)
        if not segments or segments[0].layer_lo != 0:
            raise ValueError("first segment must start at layer 0")
        if segments[-1].layer_hi != self.total_layers:
            raise ValueError("last segment must end at the trunk tail")
        for a, b in zip(segments, segments[1:]):
            if a.layer_hi != b.layer_lo:
                raise ValueError("segments must tile the trunk contiguously")
        self.segments = segments
        self._head_idx = max(
            i for i, s in enumerate(segments) if not s.is_empty
        )
        self._hints: dict[int, int] = {}
        self._hint_hist: dict[int, collections.deque] = {}

    def _segment_fn(self, seg: TierSegment, head: bool, bucket: int | None = None,
                    probe: tuple[int, ...] = (), probe_m: int | None = None
                    ) -> SegmentFn:
        """Fetch (or make) the cached function of one tier segment:
        ``bucket=None`` runs the masked full batch, ``bucket=b`` the fused
        compact(b) -> run -> scatter step; ``probe`` adds report-only heads,
        sampled on ``probe_m`` rows when set."""
        key = ((*seg.spec(head), probe, probe_m), bucket)
        fn = self._fn_cache.get(key)
        if fn is None:
            fn = self._fn_cache[key] = SegmentFn(key, seg, head, bucket, probe,
                                                 probe_m)
        return fn

    # ---------------------------------------------------- host <-> device
    def _upload(self, value, dtype: torch.dtype) -> torch.Tensor:
        """A host value on the device without a sync (pinned, async)."""
        if isinstance(value, torch.Tensor):
            return value.to(device=self.device, dtype=dtype)
        t = torch.as_tensor(np.asarray(value), dtype=dtype)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _fetch(self, fetch: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
        """The step's single device-to-host copy."""
        buf, meta = _pack(fetch)
        host = buf.cpu().numpy()
        self.host_syncs += 1
        return _unpack(host, meta)

    # ---------------------------------------------------- exit decisions
    def _exit_decision(self, logits: torch.Tensor):
        """(entropy, raw flag, argmax token) of one (B, V) head."""
        decide = (kernel_ops.entropy_exit_argmax if self.use_kernels
                  else ref.entropy_exit_argmax_ref)
        return decide(logits, self.cfg.exit_threshold)

    def _head_decisions(self, layers, logits_k: torch.Tensor):
        """Per-head (entropy, raw flag, token) of a (K, B, V) head pile in
        one decision."""
        decide = (kernel_ops.entropy_exit_argmax_heads if self.use_kernels
                  else ref.entropy_exit_argmax_heads_ref)
        e, flag, tok = decide(logits_k, self.cfg.exit_threshold)
        return {layer: (e[r], flag[r], tok[r]) for r, layer in enumerate(layers)}

    # ------------------------------------------------------------ segment
    def _run_segment(self, fn: SegmentFn, caches, x, pos_t, exited, chosen,
                     probe_rows=None) -> dict[str, Any]:
        """One tier, eagerly: masked full batch (``bucket=None``) or the
        fused compact(bucket) -> run -> scatter step, plus the report-only
        probe heads."""
        cfg, params = self.cfg, self.params
        seg, head, bucket = fn.seg, fn.head, fn.bucket
        probe, probe_m = fn.probe, fn.probe_m
        plan_set = frozenset(seg.branches)
        eval_layers = tuple(sorted({*seg.branches, *probe}))
        batch = x.shape[0]
        positions = pos_t.reshape(1) if pos_t.dim() == 0 else pos_t[:, None]
        if bucket is None:
            xb, ex, ch, rows, rows_rw = x, exited, chosen, None, None
        else:
            # Survivors first (stable: original order), then already-exited
            # padding rows up to the bucket width.
            order = torch.argsort(exited.to(torch.uint8), stable=True)
            rows = order[:bucket]
            xb, ex, ch = x[rows], exited[rows], chosen[rows]
            if positions.dim() == 2:
                positions = positions[rows]
            # Padding rows carry the out-of-bounds sentinel: their cache
            # writes drop, so KV validity is a pure function of exits.
            rows_rw = torch.where(ex, batch, rows)
        h = embed_decode(params, xb, positions, cfg) if seg.layer_lo == 0 else xb
        h, caches, collected = run_trunk(
            params, h, cfg, positions, caches,
            layer_range=(seg.layer_lo, seg.layer_hi), collect=eval_layers,
            rows=rows_rw, use_kernels=self.use_kernels,
        )
        sub = xb.shape[0]
        # A sampled probe's rows are batch indices, folded into the
        # sub-batch (a compacted tier runs a dense permutation of it).
        pr_idx = None if probe_m is None else probe_rows.long() % sub
        # The probe heads (on the sampled rows, or all) form a stack and a
        # decision of their own, so the plan heads' projection and exit
        # decision have the shapes of a normal step: the trajectory stays
        # bitwise that of a normal step on the card too.
        probe_hidden = {l: collected[l] if pr_idx is None else collected[l][pr_idx]
                        for l in probe}
        if self.batched_heads:
            dec, pdec = {}, {}
            for got, layers, into in ((collected, plan_set, dec),
                                      (probe_hidden, probe, pdec)):
                ls, lg = branch_logits_stacked(params, got, cfg, tuple(sorted(layers)))
                if lg is not None:
                    into.update(self._head_decisions(ls, lg[:, :, 0]))
        else:
            dec, pdec = [
                {l: self._exit_decision(lg[:, 0])
                 for l, lg in branch_logits_per_head(params, got, cfg).items()}
                for got in ({l: collected[l] for l in plan_set}, probe_hidden)]
        takes, ents, ptakes, pents = [], [], [], []
        for layer in eval_layers:
            if layer in plan_set:
                e, flag, btok = dec[layer]
                take = flag & ~ex
                ch = torch.where(take, btok, ch)
                ex = ex | take
                takes.append(take)
                ents.append(e)
            else:  # probe: report-only, never alters the trajectory
                e, flag, _ = pdec[layer]
                ptakes.append(flag & ~(ex if pr_idx is None else ex[pr_idx]))
                pents.append(e)
        dev = self.device
        psub = sub if probe_m is None else probe_m

        def stack(ts, width, dtype):
            return (torch.stack(ts) if ts
                    else torch.zeros((0, width), dtype=dtype, device=dev))

        take_s, ents_s = stack(takes, sub, torch.bool), stack(ents, sub, torch.float32)
        ptake_s = stack(ptakes, psub, torch.bool)
        pents_s = stack(pents, psub, torch.float32)
        out: dict[str, Any] = {}
        logits = None
        if head:
            hf = norm_apply(cfg.norm_type, params["final_norm"], h)
            logits = _unembed(params, hf, cfg)[:, 0]
            ch = torch.where(ex, ch, logits.argmax(-1).to(torch.int32))
            caches["length"] += 1
        # Probe reports in batch order: their columns are the sub-batch's
        # rows, all of them or the sampled ones.
        if bucket is None and probe_m is None:
            out["ptake"], out["pents"] = ptake_s, pents_s
        else:
            pcols = (pr_idx if bucket is None
                     else rows if probe_m is None else rows[pr_idx])
            out["ptake"] = _scatter(batch, pcols, ptake_s)
            out["pents"] = _scatter(batch, pcols, pents_s)
            if probe_m is not None:
                out["pcover"] = _scatter(
                    batch, pcols, torch.ones_like(pcols, dtype=torch.bool))
        if bucket is None:
            out["exited"], out["chosen"] = ex, ch
            out["take"], out["ents"] = take_s, ents_s
            if head:
                out["logits"] = logits
            else:
                out["hidden"] = h
            return out
        # Scatter back to batch order, on the device.
        out["exited"] = exited.index_copy(0, rows, ex)
        out["chosen"] = chosen.index_copy(0, rows, ch)
        out["take"] = _scatter(batch, rows, take_s)
        out["ents"] = _scatter(batch, rows, ents_s)
        if head:
            out["logits"] = torch.zeros(
                (batch, logits.shape[-1]), dtype=logits.dtype, device=dev
            ).index_copy_(0, rows, logits)
        else:
            out["hidden"] = torch.zeros(
                (batch, 1, h.shape[-1]), dtype=h.dtype, device=dev
            ).index_copy_(0, rows, h)
        return out

    def _layout(self, caches) -> tuple[tuple, tuple | None]:
        """(the caches' shapes and dtypes, their addresses under graphs):
        a variant's signature and a graph's binding."""
        leaves = list(_leaves(caches))
        shapes = tuple((tuple(t.shape), t.dtype) for t in leaves)
        return shapes, (tuple(t.data_ptr() for t in leaves) if self.graphs else None)

    def call_segment(self, fn: SegmentFn, x, pos_t, exited, chosen, caches,
                     layout=None, probe_rows=None) -> dict[str, Any]:
        """Run one cached segment function: the eager call, or (graphs)
        the replay of its captured variant, capturing it at its first use
        (see the module doc).  Returns the segment's outputs — under graphs
        the static outputs of its graph, valid until its next replay."""
        shapes, binding = layout or self._layout(caches)
        args = (x, pos_t, exited, chosen) + (
            () if probe_rows is None else (probe_rows,))
        sig = (pos_t.dim(), tuple(x.shape), shapes)
        var = fn.variants.get(sig)
        if not self.graphs:
            if var is None:
                fn.variants[sig] = True
                self.trace_counts[fn.key] = self.trace_counts.get(fn.key, 0) + 1
            return self._run_segment(fn, caches, *args)
        if var is not None and var.binding == binding:
            for buf, a in zip(var.inputs, args):
                buf.copy_(a)
            var.graph.replay()
            kernel_ops.add_launches(var.launches)
            self.replays[fn.key] = self.replays.get(fn.key, 0) + 1
            return var.out
        out, fn.variants[sig] = self._capture(fn, args, caches, binding)
        self.trace_counts[fn.key] = self.trace_counts.get(fn.key, 0) + 1
        return out

    def _capture(self, fn: SegmentFn, args, caches, binding):
        """The first use of a variant under graphs: the real step, eagerly,
        on the capture stream, then the same call captured (which runs
        nothing) over static copies of the inputs.  Returns (the eager
        outputs, the :class:`_Graph`)."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream, cur = self._stream, torch.cuda.current_stream(self.device)
        inputs = tuple(a.clone() for a in args)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            out = self._run_segment(fn, caches, *inputs)
        cur.wait_stream(stream)
        # capture_begin / capture_end, not ``torch.cuda.graph``: that context
        # synchronizes the device and empties the allocator's cache on entry,
        # a second host sync in the step (and cudaMallocs after it).  The
        # capture only records, so the eager run above need not be finished.
        graph = torch.cuda.CUDAGraph()
        try:
            with kernel_ops.recording() as recorded, torch.cuda.device(self.device), \
                    torch.cuda.stream(stream):
                graph.capture_begin()
                try:
                    static = self._run_segment(fn, caches, *inputs)
                finally:
                    graph.capture_end()
        except RuntimeError as e:
            raise RuntimeError(
                f"capturing segment {fn.key} as a CUDA graph failed") from e
        return out, _Graph(binding, graph, inputs, static, recorded)

    # ---------------------------------------------- overflow-retry state
    def _stateful(self, caches):
        """(KV rings, Mamba2 states) of the caches: the stacked ``self``
        dicts of the trunk's attention stacks and hybrid shared-attention
        sites, and of its Mamba2 stacks."""
        rings, states = [], []
        for name, kind, _n in trunk_layout(self.cfg):
            (rings if kind.mixer == "gqa" else states).append(caches[name]["self"])
        if hybrid_sites(self.cfg):
            rings.append(caches["shared_attn"]["self"])
        return rings, states

    def _snapshot(self, caches, pos_t):
        """Everything this step can write, per layer and row, plus the
        step counters — what a re-run must restore (see module doc)."""
        rings, states = self._stateful(caches)
        saved = []
        for kv in rings:
            n, bc, c = kv["pos"].shape
            if pos_t.dim() == 1:
                slots = (pos_t.long() % c)[None, :].expand(n, bc)
            else:
                slots = (kv["length"].long() % c)[:, None].expand(n, bc)
            li = torch.arange(n, device=self.device)[:, None]
            bi = torch.arange(bc, device=self.device)[None, :]
            idx = (li, bi, slots)
            saved.append((kv, idx, {k: kv[k][idx].clone() for k in ("k", "v", "pos")}))
        for st in states:
            saved.append((st, None, {k: st[k].clone() for k in ("conv", "ssm")}))
        lengths = [(t, t.clone()) for t in
                   (caches["length"], *(c["length"] for c in rings + states))]
        return saved, lengths

    @staticmethod
    def _restore(snapshot, caches) -> None:
        saved, lengths = snapshot
        for buf, idx, vals in saved:
            for k, v in vals.items():
                if idx is None:
                    buf[k].copy_(v)
                else:
                    buf[k][idx] = v
        for t, v in lengths:
            t.copy_(v)

    # -------------------------------------------------------------- step
    def _plan_buckets(self, batch: int) -> dict[int, int]:
        """Host-side bucket per downstream segment: the windowed-max hint
        (full batch where none exists yet), inflated by the headroom and
        rounded up the ladder."""
        if self.compaction != "bucketed":
            return {}
        executed = [i for i, s in enumerate(self.segments) if not s.is_empty]
        buckets = {}
        for i in executed[1:]:
            hint = self._hints.get(i, batch)
            padded = min(batch, math.ceil(hint * (1.0 + self.bucket_headroom)))
            buckets[i] = bucket_for(padded, batch)
        return buckets

    def _observe_hints(self, entering: dict[int, int]) -> None:
        for i, count in entering.items():
            hist = self._hint_hist.get(i)
            if hist is None or hist.maxlen != self.hint_window:
                hist = collections.deque(hist or (), maxlen=self.hint_window)
                self._hint_hist[i] = hist
            hist.append(count)
        self._hints = {i: max(h) for i, h in self._hint_hist.items() if h}

    def _probe_layers(self) -> dict[int, tuple[int, ...]]:
        """Branch layers a probe step evaluates on top of the plan, by
        segment: every ``cfg.branch_layers`` head on the tier whose layer
        range holds it (a branch at a cut probes on the upstream tier)."""
        out: dict[int, tuple[int, ...]] = {}
        for i, seg in enumerate(self.segments):
            if seg.is_empty:
                continue
            extra = tuple(sorted(
                b for b in self.cfg.branch_layers
                if seg.layer_lo < b <= seg.layer_hi and b not in seg.branches
            ))
            if extra:
                out[i] = extra
        return out

    def _probe_sample(self, batch: int, active_np
                      ) -> tuple[np.ndarray | None, int | None]:
        """A sampled probe's rows and width: the fraction of the nominal
        batch, capped at the live rows and floored to the bucket ladder,
        taken by a rotation over the live rows (None when it covers the
        whole batch)."""
        pool = (np.flatnonzero(active_np)
                if active_np is not None and active_np.any() else np.arange(batch))
        want = min(max(1, math.ceil(self.probe_sample_frac * batch)), len(pool))
        m = max(b for b in bucket_ladder(batch) if b <= want)
        if m >= batch:
            return None, None
        sel = pool[(self._probe_offset + np.arange(m)) % len(pool)]
        self._probe_offset = (self._probe_offset + m) % len(pool)
        return sel, m

    def dispatch(self, tok, pos_t, caches, buckets: dict[int, int],
                 exited0: torch.Tensor | None = None, probe_map=None,
                 probe_rows: torch.Tensor | None = None, probe_m: int | None = None):
        """Enqueue every tier segment of one step; no host sync.  Returns
        (tensors to fetch, chosen tokens, main-head logits); under graphs
        they are graph outputs, valid until the segments replay again."""
        probe_map = probe_map or {}
        batch = tok.shape[0]
        exited = (torch.zeros((batch,), dtype=torch.bool, device=self.device)
                  if exited0 is None else exited0)
        chosen = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        layout = self._layout(caches)
        x = tok
        fetch: dict[str, torch.Tensor] = {}
        logits = None
        for i, seg in enumerate(self.segments):
            if seg.is_empty:
                continue
            head = i == self._head_idx
            b = buckets.get(i)
            pr = probe_map.get(i, ())
            sampled = bool(pr) and probe_m is not None
            fn = self._segment_fn(seg, head, None if b is None else min(b, batch),
                                  pr, probe_m if sampled else None)
            out = self.call_segment(fn, x, pos_t, exited, chosen, caches, layout,
                                    probe_rows if sampled else None)
            exited, chosen = out["exited"], out["chosen"]
            if seg.branches:
                fetch[f"take{i}"] = out["take"]
                fetch[f"ents{i}"] = out["ents"]
            if pr:
                fetch[f"ptake{i}"] = out["ptake"]
                fetch[f"pents{i}"] = out["pents"]
                if sampled:
                    fetch[f"pcover{i}"] = out["pcover"]
            if head:
                logits = out["logits"]
            else:
                x = out["hidden"]
        fetch["tokens"] = chosen
        fetch["exited"] = exited
        return fetch, chosen, logits

    def _run_once(self, tok, pos_t, caches, buckets, exited0, active_np,
                  probe_map, probe_rows, probe_m):
        """Dispatch all segments and make the single fetch; returns (host
        dict, entering-survivor counts, chosen, logits, alive counts)."""
        batch = tok.shape[0]
        fetch, chosen, logits = self.dispatch(tok, pos_t, caches, buckets,
                                              exited0, probe_map, probe_rows,
                                              probe_m)
        host = self._fetch(fetch)
        exited_run = (np.zeros((batch,), bool) if active_np is None
                      else ~active_np)
        alive_after_seg = {}
        for i, seg in enumerate(self.segments):
            for row, _layer in enumerate(seg.branches):
                exited_run |= host[f"take{i}"][row]
            alive_after_seg[i] = int(batch - exited_run.sum())
        entering = {
            i: alive_after_seg[i - 1]
            for i in range(1, len(self.segments))
            if not self.segments[i].is_empty
        }
        return host, entering, chosen, logits, alive_after_seg

    def step(self, tok, pos, caches: dict, *, active=None
             ) -> tuple[TierStepResult, dict]:
        """One decode step across all tiers: one host sync (plus one per
        rare overflow re-run).  ``tok`` (B, 1) tokens (on the device, or
        host values); ``pos`` the shared step position or a per-sequence
        (B,) vector; ``active`` (B,) marks live slots (dead slots enter
        pre-exited)."""
        cfg = self.cfg
        tok = self._upload(tok, torch.int32)
        batch = tok.shape[0]
        active_np = None if active is None else np.array(active, dtype=bool)
        live = batch if active_np is None else int(active_np.sum())
        pos_t = self._upload(pos, torch.int32)
        exited0 = None if active_np is None else self._upload(~active_np, torch.bool)
        probe_map = self._probe_layers() if self.probe_next else {}
        self.probe_next = False
        probe_rows, probe_m = None, None
        if probe_map and self.probe_sample_frac < 1.0:
            sel, probe_m = self._probe_sample(batch, active_np)
            if sel is not None:
                probe_rows = self._upload(sel, torch.int32)
        buckets = self._plan_buckets(batch)
        snap = (self._snapshot(caches, pos_t)
                if any(b < batch for b in buckets.values()) else None)
        run = (tok, pos_t, caches)
        extra = (exited0, active_np, probe_map, probe_rows, probe_m)
        host, entering, chosen, logits, alive = self._run_once(*run, buckets, *extra)
        used = {i: min(buckets.get(i, batch), batch) for i in entering}
        # Overflow: true survivors exceeded a planned bucket, so excluded
        # survivors carry garbage.  Restore the entry state and re-run with
        # measured buckets (non-decreasing, so this ends in <= K runs; the
        # last resort is full-batch buckets).
        attempts = 0
        while any(entering[i] > used[i] for i in entering):
            self.overflow_retries += 1
            attempts += 1
            if attempts >= len(self.segments):
                buckets = {i: batch for i in entering}
            else:
                buckets = {
                    i: max(min(buckets.get(i, 1), batch),
                           bucket_for(entering[i], batch))
                    for i in entering
                }
            self._restore(snap, caches)
            host, entering, chosen, logits, alive = self._run_once(*run, buckets,
                                                                   *extra)
            used = {i: min(buckets.get(i, batch), batch) for i in entering}
        self._observe_hints(entering)
        if self.graphs:
            # Graph outputs are rewritten by the next replay: the step's
            # device results leave it as copies of their own.
            chosen = chosen.clone()
            logits = None if logits is None else logits.clone()

        # Probe branches report would-exit masks and entropies only; they
        # never touch exit_tier.
        exit_tier = np.full((batch,), -1, np.int32)
        branch_take: dict[int, np.ndarray] = {}
        branch_entropy: dict[int, np.ndarray] = {}
        branch_probe_mask: dict[int, np.ndarray] = {}
        for i, seg in enumerate(self.segments):
            for row, layer in enumerate(seg.branches):
                mask = host[f"take{i}"][row]
                branch_take[layer] = mask
                branch_entropy[layer] = host[f"ents{i}"][row]
                exit_tier[mask] = i
            for row, layer in enumerate(probe_map.get(i, ())):
                branch_take[layer] = host[f"ptake{i}"][row]
                branch_entropy[layer] = host[f"pents{i}"][row]
                if probe_m is not None:
                    branch_probe_mask[layer] = host[f"pcover{i}"]

        shipped, nbytes, compaction = [], [], []
        for j in range(self._head_idx):
            alive_j = alive[j]
            shipped.append(alive_j)
            nbytes.append(alive_j * bytes_per_sequence(cfg, self.segments[j].layer_hi))
            nxt = next(i for i in range(j + 1, len(self.segments))
                       if not self.segments[i].is_empty)
            compaction.append(HopCompaction(alive_j, used.get(nxt, batch)))

        result = TierStepResult(
            tokens=host["tokens"],
            exited=host["exited"],
            exit_tier=exit_tier,
            branch_take=branch_take,
            branch_entropy=branch_entropy,
            shipped_per_hop=tuple(shipped),
            bytes_per_hop=tuple(nbytes),
            tokens_dev=chosen,
            last_logits=logits,
            compaction=tuple(compaction),
            live=live,
            active=active_np,
            branch_probe_mask=branch_probe_mask,
        )
        return result, caches

    # ------------------------------------------------- request admission
    def prefill_rows(self, caches: dict, tokens, rows) -> tuple[dict, torch.Tensor]:
        """Admit a block of prompts into cache rows in place: prompt row i
        prefills row ``rows[i]``, ending exactly as a fresh solo prefill.
        ``rows`` is a host-side plan; sentinel rows (>= batch) drop.  Runs
        eagerly, also under graphs (see the module doc).  Returns (caches,
        first decode input token per prompt row (n,), on the device — no
        device-to-host sync)."""
        toks = self._upload(tokens, torch.int64)
        logits, caches = prefill(self.params, toks, self.cfg, caches,
                                 rows=np.asarray(rows, np.int64),
                                 use_kernels=self.use_kernels)
        return caches, logits[:, 0].argmax(-1).to(torch.int32)

    def reset_rows(self, caches: dict, rows) -> dict:
        """Mark cache rows empty without moving K/V: ring slot validity
        (``pos``) -> -1, Mamba2 conv window and SSM state -> 0; sentinel
        rows (>= batch) are ignored.  Runs eagerly."""
        rows = np.asarray(rows, np.int64)
        rings, states = self._stateful(caches)
        for buf, key, fill in ([(kv, "pos", -1) for kv in rings]
                               + [(st, k, 0) for st in states
                                  for k in ("conv", "ssm")]):
            t = buf[key]
            keep = rows[rows < t.shape[1]]
            if keep.size:
                t[:, torch.as_tensor(keep, device=self.device)] = fill
        return caches


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
