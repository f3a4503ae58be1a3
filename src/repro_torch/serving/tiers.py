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

  * **No jit.**  PyTorch runs eagerly; a segment is a method call.
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
    nothing can overflow).
  * **The single fetch** packs every fetched tensor into one int32 buffer,
    so a step costs one device-to-host copy, as the reference's one
    ``device_get`` does.  Host inputs (positions, the live mask) go up
    through pinned memory without a sync.

Not ported yet (see ROADMAP.md): mesh-sharded segments, the fault plane
and degraded steps, ``overlap="pipelined"``, probe steps and
``simulate_network``.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.multitier import bucket_for
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
    "TierExecutor",
    "TierSegment",
    "TierStepResult",
    "TOKEN_ID_BYTES",
    "bytes_per_sequence",
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


@dataclasses.dataclass
class TierStepResult:
    """Everything a server needs from one decode step, fetched in one
    device-to-host copy (except the device-resident feedback tensors).
    In compacted mode, ``branch_entropy`` and ``last_logits`` rows of
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


class TierExecutor:
    """Runs the K-hop decode step with survivor compaction at every hop.

    ``device``: where params, caches and every tensor of the step live
    (None = the current CUDA device; raises without one — pass "cpu" to
    run the plain versions on the CPU).  ``use_kernels``: None = the
    config's, then auto (Hopper kernels on CUDA, plain versions on the
    CPU); the kernels anywhere but CUDA sm_90 raise.  The params are held once as
    their compute-dtype copies (:func:`repro_torch.models.model.
    compute_params`)."""

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
        self.params = compute_params(_to_device(params, self.device),
                                     compute_dtype(cfg))
        self.compaction = compaction
        self.batched_heads = bool(batched_heads)
        self.hint_window = hint_window
        self.bucket_headroom = bucket_headroom
        self.total_layers = sum(n for _, _, n in trunk_layout(cfg))
        self.host_syncs = 0
        self.overflow_retries = 0
        self.install(segments)

    # -------------------------------------------------------------- plan
    def install(self, segments: Sequence[TierSegment]) -> None:
        """Install a new tier plan; survivor hints restart at full batch."""
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
    def _run_segment(self, seg: TierSegment, head: bool, bucket: int | None,
                     x, pos_t, exited, chosen, caches) -> dict[str, Any]:
        """One tier: masked full batch (``bucket=None``) or the fused
        compact(bucket) -> run -> scatter step."""
        cfg, params = self.cfg, self.params
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
            layer_range=(seg.layer_lo, seg.layer_hi), collect=seg.branches,
            rows=rows_rw, use_kernels=self.use_kernels,
        )
        sub = xb.shape[0]
        takes, ents = [], []
        if seg.branches:
            if self.batched_heads:
                layers, lg = branch_logits_stacked(params, collected, cfg,
                                                   seg.branches)
                dec = self._head_decisions(layers, lg[:, :, 0])
            else:
                per_head = branch_logits_per_head(params, collected, cfg)
                dec = {l: self._exit_decision(per_head[l][:, 0])
                       for l in seg.branches}
            for layer in sorted(seg.branches):
                e, flag, btok = dec[layer]
                take = flag & ~ex
                ch = torch.where(take, btok, ch)
                ex = ex | take
                takes.append(take)
                ents.append(e)
        take_s = (torch.stack(takes) if takes
                  else torch.zeros((0, sub), dtype=torch.bool, device=self.device))
        ents_s = (torch.stack(ents) if ents
                  else torch.zeros((0, sub), dtype=torch.float32, device=self.device))
        out: dict[str, Any] = {}
        logits = None
        if head:
            hf = norm_apply(cfg.norm_type, params["final_norm"], h)
            logits = _unembed(params, hf, cfg)[:, 0]
            ch = torch.where(ex, ch, logits.argmax(-1).to(torch.int32))
            caches["length"] += 1
        if bucket is None:
            out["exited"], out["chosen"] = ex, ch
            out["take"], out["ents"] = take_s, ents_s
            if head:
                out["logits"] = logits
            else:
                out["hidden"] = h
            return out
        # Scatter back to batch order, on the device.
        nbr = len(seg.branches)
        dev = self.device
        out["exited"] = exited.index_copy(0, rows, ex)
        out["chosen"] = chosen.index_copy(0, rows, ch)
        out["take"] = torch.zeros((nbr, batch), dtype=torch.bool,
                                  device=dev).index_copy_(1, rows, take_s)
        out["ents"] = torch.zeros((nbr, batch), dtype=torch.float32,
                                  device=dev).index_copy_(1, rows, ents_s)
        if head:
            out["logits"] = torch.zeros(
                (batch, logits.shape[-1]), dtype=logits.dtype, device=dev
            ).index_copy_(0, rows, logits)
        else:
            out["hidden"] = torch.zeros(
                (batch, 1, h.shape[-1]), dtype=h.dtype, device=dev
            ).index_copy_(0, rows, h)
        return out

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

    def dispatch(self, tok, pos_t, caches, buckets: dict[int, int],
                 exited0: torch.Tensor | None = None):
        """Enqueue every tier segment of one step; no host sync.  Returns
        (tensors to fetch, chosen tokens, main-head logits)."""
        batch = tok.shape[0]
        exited = (torch.zeros((batch,), dtype=torch.bool, device=self.device)
                  if exited0 is None else exited0)
        chosen = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        x = tok
        fetch: dict[str, torch.Tensor] = {}
        logits = None
        for i, seg in enumerate(self.segments):
            if seg.is_empty:
                continue
            head = i == self._head_idx
            b = buckets.get(i)
            out = self._run_segment(seg, head, None if b is None else min(b, batch),
                                    x, pos_t, exited, chosen, caches)
            exited, chosen = out["exited"], out["chosen"]
            if seg.branches:
                fetch[f"take{i}"] = out["take"]
                fetch[f"ents{i}"] = out["ents"]
            if head:
                logits = out["logits"]
            else:
                x = out["hidden"]
        fetch["tokens"] = chosen
        fetch["exited"] = exited
        return fetch, chosen, logits

    def _run_once(self, tok, pos_t, caches, buckets, exited0, active_np):
        """Dispatch all segments and make the single fetch; returns (host
        dict, entering-survivor counts, chosen, logits, alive counts)."""
        batch = tok.shape[0]
        fetch, chosen, logits = self.dispatch(tok, pos_t, caches, buckets,
                                              exited0)
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

    def step(self, tok: torch.Tensor, pos, caches: dict, *, active=None
             ) -> tuple[TierStepResult, dict]:
        """One decode step across all tiers: one host sync (plus one per
        rare overflow re-run).  ``tok`` (B, 1) on the device; ``pos`` the
        shared step position or a per-sequence (B,) vector; ``active`` (B,)
        marks live slots (dead slots enter pre-exited)."""
        cfg = self.cfg
        batch = tok.shape[0]
        active_np = None if active is None else np.array(active, dtype=bool)
        live = batch if active_np is None else int(active_np.sum())
        pos_t = self._upload(pos, torch.int32)
        exited0 = None if active_np is None else self._upload(~active_np, torch.bool)
        buckets = self._plan_buckets(batch)
        snap = (self._snapshot(caches, pos_t)
                if any(b < batch for b in buckets.values()) else None)
        host, entering, chosen, logits, alive = self._run_once(
            tok, pos_t, caches, buckets, exited0, active_np)
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
            host, entering, chosen, logits, alive = self._run_once(
                tok, pos_t, caches, buckets, exited0, active_np)
            used = {i: min(buckets.get(i, batch), batch) for i in entering}
        self._observe_hints(entering)

        exit_tier = np.full((batch,), -1, np.int32)
        branch_take: dict[int, np.ndarray] = {}
        branch_entropy: dict[int, np.ndarray] = {}
        for i, seg in enumerate(self.segments):
            for row, layer in enumerate(seg.branches):
                mask = host[f"take{i}"][row]
                branch_take[layer] = mask
                branch_entropy[layer] = host[f"ents{i}"][row]
                exit_tier[mask] = i

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
        )
        return result, caches

    # ------------------------------------------------- request admission
    def prefill_rows(self, caches: dict, tokens, rows) -> tuple[dict, torch.Tensor]:
        """Admit a block of prompts into cache rows in place: prompt row i
        prefills row ``rows[i]``, ending exactly as a fresh solo prefill.
        ``rows`` is a host-side plan; sentinel rows (>= batch) drop.
        Returns (caches, first decode input token per prompt row (n,),
        on the device — no device-to-host sync)."""
        toks = self._upload(tokens, torch.int64)
        logits, caches = prefill(self.params, toks, self.cfg, caches,
                                 rows=np.asarray(rows, np.int64),
                                 use_kernels=self.use_kernels)
        return caches, logits[:, 0].argmax(-1).to(torch.int32)

    def reset_rows(self, caches: dict, rows) -> dict:
        """Mark cache rows empty without moving K/V: ring slot validity
        (``pos``) -> -1, Mamba2 conv window and SSM state -> 0; sentinel
        rows (>= batch) are ignored."""
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
