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
    key is ``((layer_lo, layer_hi, branches, head, probe, probe_m,
    degrade), bucket)``), and ``install`` reuses every entry whose key is
    unchanged.
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
    restore, the packed fetch, and ``reset_rows``, which takes a host-side
    row plan.  A step still makes exactly one host sync.
  * **Padded admission** (``padded_admission``: on the card, unsharded,
    and every trunk block GQA or Mamba2 with a dense MLP or none).  The
    row-targeted ``prefill_rows`` drops sentinel rows on the host
    (``models/attention.py::plan_rows``, two blocking copies a layer) and
    launches thousands of kernels a prompt.  Padded, each prompt runs one
    sync-free body for one row, at the prompt-length rung that holds it:
    rungs are the powers of two from 16 up to :data:`ADMISSION_TOP`, or to
    the rings' capacity where that is less, the capacity then the last
    rung (:func:`admission_ladder`).  The body
    (:func:`~repro_torch.models.model.prefill` under a
    :class:`~repro_torch.models.attention.PaddedPrompt`) leaves the row as
    the unpadded prompt's prefill would, up to a GEMM's rounding at
    another M.  Under graphs the executor keeps one CUDA graph per rung:
    the first ``prefill_rows`` on a cache layout captures every rung at
    once (on a sentinel row, which writes nothing; the first rung warmed
    up eagerly first; one memory pool for the ladder), counted in
    ``trace_counts`` under ``("prefill", rung)``; every later call only
    replays, one replay per real prompt (``replays``), its tokens padded
    to the rung and its row and length uploaded as one pinned,
    non-blocking copy into the graph's static input.  Without graphs the
    body is called directly.  A prompt longer than the top rung pays the
    padded prompt's quadratic attention for more than the launches a
    graph saves, so it takes the row-targeted prefill, as the CPU, a
    sharded executor, and MoE, MLA, audio or vision trunks do.
  * **Caches update in place** (a full-size cache is 12.9 GB).  The
    reference re-runs an overflowed step from its immutable entry caches;
    here the step first snapshots what it can write and restores it before
    a re-run: for every KV ring (trunk layers and hybrid shared-attention
    sites) and every MLA latent ring (its ``ckv``, ``k_rope`` and ``pos``),
    per layer and row, the one slot the step writes (``pos % C``,
    or ``length % C`` in lock-step) — a few MB instead of a clone of the
    cache; for every Mamba2 layer the whole conv window and SSM state,
    which a step overwrites in every row it runs (about 320 MB at
    Zamba2-1.2B's size); and every step counter.  The snapshot is taken
    only when some planned bucket is narrower than the batch (otherwise
    nothing can overflow).  A re-run replays the measured buckets' graphs.
  * **The single fetch** packs every fetched tensor into one int32 buffer,
    so a step costs one device-to-host copy, as the reference's one
    ``device_get`` does.
  * **Spans** (``tracer``, :mod:`repro_torch.serving.trace`): while a
    tracer is attached a step records ``tiers.step`` and inside it
    ``tiers.plan``, ``tiers.snapshot``, one ``tiers.segment`` per segment
    call, ``tiers.fetch``, ``tiers.rerun`` per overflow re-run and
    ``tiers.report``, with CUDA events around each graph replay and the
    snapshot's clones; ``prefill_rows`` sets ``mode`` (``replay``,
    ``eager`` or ``capture``) and ``bucket`` (the rung, or the prompt's
    length when eager) on the span open around it; without one, nothing.

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

Link simulation (``simulate_network``): each segment carries its uplink
(``TierSegment.uplink_bps``, bits/s); after the step's one fetch the host
sleeps each hop's ``shipped bytes * 8 / uplink_bps`` and reports it in
``TierStepResult.sim_transfer_s``, so the step's wall time pays the link.
A hop that must ship bytes over an unset or zero uplink raises
:class:`~repro_torch.serving.faults.LinkDownError` when no fault model is
attached (a dead link is never priced free).

Pipelined overlap (``overlap="pipelined"``), as in the reference: only
the simulated sleeps are pipelined, never the computation.  Each hop has a
host link clock; hop j's transfer of token t starts when its payload has
cleared hop j-1 and the link has finished token t-1's transfer, and a step
returns once the *previous* step's transfers have drained (double-buffer
depth 1), so the steady step is ``max(compute, max_j transfer_j)`` instead
of their sum.  The graph replays are already asynchronous to the host, so
no CUDA stream or event is involved.  Tokens, masks, bytes and
``sim_transfer_s`` are bitwise those of serial mode.  An overflow re-run
or a degraded or failed step drains the pipeline and pays its transfers
serially (``pipeline_fallbacks``); ``install`` and :meth:`drain` drain it.

Fault plane (``fault_model`` / ``hop_policy``; a policy alone arms a
benign :class:`~repro_torch.serving.faults.LinkFaultModel`):

  * **Phase A**, on the host before any dispatch and without a sync
    (:meth:`TierExecutor._plan_hops`): every hop the plan crosses is
    checked in order — its circuit breaker, then up to ``1 + max_retries``
    attempts against the step's seeded draw, the deadline judged on the
    full-batch payload — so the decision depends on ``(seed, fault step,
    hop)`` only and replays bit for bit.
  * A broken hop degrades the step: it runs only up to the segment holding
    the deepest exit head at or below the broken hop's cut (a branch at
    the cut, which a healthy plan discards, included), and every live row
    not already exited is finalized from that head's argmax.  That
    terminal segment is a key of its own, ``((lo, hi, branches, head,
    probe, probe_m, degrade), bucket)``, captured and replayed like any
    other; the fallback head joins the segment's stacked exit heads, and
    the segment bumps the cache clock the absent head tier would have.  A
    degraded step still makes one sync; its forced rows are reported in
    ``degraded`` (``exit_tier`` = the fallback tier) and never in
    ``branch_take``.
  * With no exit head at or below the broken hop, the step dispatches
    nothing and fetches nothing: every live row is reported ``failed``.
  * Under ``simulate_network`` the hops that held charge their
    (multiplier-scaled, spike-added) transfer plus the overhead of failed
    attempts; a broken hop charges only that overhead.

A benign model (no flaps, drops or spikes, multiplier 1) leaves every
token, mask, cache write and byte count bitwise as without it.

Mesh-sharded tier segments (``mesh`` / ``sharding``): a tier in a fleet
is a group of cards, not one.  Passing a ``DeviceMesh``
(:func:`~repro_torch.launch.mesh.make_local_mesh`; optionally an explicit
:class:`~repro_torch.sharding.policy.ShardingPolicy`, by default
:func:`~repro_torch.sharding.policy.make_policy`) runs every segment as one
program over the mesh's ranks on ``torch.distributed.tensor``:

  * **params** are placed once at construction under the policy's
    ``param_spec`` rules (attention projections, FFN hidden, expert dim and
    vocab on ``model``; FSDP over ``data`` where configured; indivisible
    dims replicated) as DTensors;
  * **KV / SSM caches** are placed by :meth:`TierExecutor.shard_caches`
    (callers run it right after ``init_caches``) under ``cache_spec``:
    kv-heads on ``model`` when divisible, else head_dim.  Steps write them
    in place, each rank on its own shard;
  * **activations** follow from DTensor's sharding rules; inside a segment
    the model's ``constrain`` call sites redistribute them through the
    :mod:`repro_torch.sharding.ctx` context, and plain tensors (tokens,
    positions, masks) count as replicated.  Where DTensor has no rule the
    call site is explicit and says so: the ring writes and the attention
    run on each rank's shard, a reshape that splits a head gathers first,
    and the exit heads' and the final head's logits are gathered whole, so
    a step's row bookkeeping (exits, tokens, compaction) is plain tensors,
    equal on every rank;
  * **kernels** resolve to the plain versions
    (``resolve_use_kernels(..., sharded=True)``): the Hopper kernels are
    single-device programs and must not see a mesh-global batch;
  * **CUDA graphs** do not apply: a gloo collective cannot be captured, so
    ``graphs=None`` resolves to eager and ``graphs=True`` raises.

The sharded-segment contract: every unsharded invariant holds — exactly
one host sync per decode step on each rank (the step's outputs are
gathered to every rank before the one fetch), survivor compaction with the
same bucket ladder, the segment cache (hot-swapping a cut rebuilds no
unchanged segment), per-request isolation — and the token, exit-mask and
shipped-count trajectory is the unsharded one.  Logits are not bitwise:
partial sums reduce in another order.  Every rank must drive the same
steps with the same host inputs; host-side decisions (buckets, hints) are
taken from the fetched values, which are equal on every rank.

All segments share the executor's mesh: which tier is sharded is a cost
model property, carried by ``TierSegment.devices`` (not part of the
segment key) and ``TierSpec.devices``: the lattice prices a sharded tier's
layers at ``t_c / devices`` plus two ring all-reduces of the layer's
output per layer (:mod:`repro_torch.core.multitier`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import math
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.multitier import bucket_for, bucket_ladder
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref
from repro_torch.launch.mesh import mesh_devices
from repro_torch.models.attention import PaddedPrompt
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
from repro_torch.serving.faults import (
    CircuitBreaker,
    FaultEvent,
    HopOutcome,
    HopPolicy,
    LinkDownError,
    LinkFaultModel,
    attempt_hop,
)
from repro_torch.sharding import ctx as shard_ctx
from repro_torch.sharding.policy import make_policy

__all__ = [
    "HopCompaction",
    "LinkDownError",
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
    (absolute, 0-based), the 1-based branch points it evaluates, the
    uplink to the next tier (bits/s; None on the last tier), and the tier's
    shard width (``devices > 1``: the tier is a mesh; a cost-model term,
    not part of the segment's key)."""

    name: str
    layer_lo: int
    layer_hi: int
    branches: tuple[int, ...] = ()
    uplink_bps: float | None = None
    devices: int = 1

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
    reports 0.0 for byte accounting (the cost model prices an unusable hop
    infinite).  The ``simulate_network`` step never prices a dead uplink
    with bytes queued: it raises :class:`LinkDownError` or degrades
    through the fault plane."""
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
    uplinks: Sequence[float] | None = None,
    devices: Sequence[int] | None = None,
) -> tuple[TierSegment, ...]:
    """Monotone 1-based cut points ``(c_1 .. c_{K-1})`` -> K segments.
    Tier j runs layers ``(c_j, c_{j+1}]``; branches sit strictly inside a
    tier, never on the final tier of a K >= 2 plan.  ``uplinks[j]`` is
    tier j's uplink (the last tier has none); ``devices[j]`` its shard
    width (default 1)."""
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
        up = uplinks[j] if uplinks and j < len(uplinks) and j < k - 1 else None
        dev = int(devices[j]) if devices and j < len(devices) else 1
        segs.append(TierSegment(names[j] if names else f"tier{j}", lo, hi, brs, up,
                                dev))
    return tuple(segs)


def resolve_graphs(flag: bool | None, device, *, sharded: bool = False) -> bool:
    """The ``graphs`` tri-state for an executor on ``device``: None = CUDA
    graphs on a CUDA device, eager on the CPU; True off CUDA raises;
    False runs eager on the card too (the comparison baseline).  A sharded
    executor runs eager (None) or raises (True): a gloo collective cannot
    be captured."""
    dev = torch.device(device)
    if sharded:
        if flag:
            raise ValueError("graphs=True on a sharded mesh: its collectives "
                             "cannot be captured in a CUDA graph")
        return False
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
    sequences that were never computed downstream are zero; a degraded or
    failed step runs no head tier, so its ``last_logits`` is None."""

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
    sim_transfer_s: tuple[float, ...] = ()  # simulated uplink time per hop
    live: int = 0  # sequences live at step entry
    active: np.ndarray | None = None  # the live mask the step ran with
    #: Sampled probe steps only: layer -> (B,) rows whose probed head was
    #: evaluated; the controller counts arrivals over these rows.  Empty
    #: for full probes and normal steps.
    branch_probe_mask: dict[int, np.ndarray] = dataclasses.field(
        default_factory=dict)
    #: Fault plane (see the module doc): rows finalized from the fallback
    #: head below a broken hop, rows that could not emit at all (both None
    #: on a healthy step), the step's replayable trace, and the broken hop
    #: (None = healthy).
    degraded: np.ndarray | None = None
    failed: np.ndarray | None = None
    fault_events: tuple[FaultEvent, ...] = ()
    degraded_hop: int | None = None


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
    branches, head, probe, probe_m, degrade), bucket)``; ``variants`` maps an
    argument signature to its build (True for an eager variant, a
    :class:`_Graph` under graphs).  The executor calls it
    (:meth:`TierExecutor.call_segment`)."""

    key: tuple
    seg: TierSegment
    head: bool
    bucket: int | None
    probe: tuple[int, ...] = ()
    probe_m: int | None = None
    degrade: int | None = None  # a degraded step's fallback head layer
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


@contextlib.contextmanager
def _collector_held():
    """Python's cyclic collector held off for a CUDA graph capture: a
    collection inside one can free another graph and release its memory
    pool, a call that ends the capture in error."""
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_on:
            gc.enable()


#: The longest prompt padded admission takes.  Past it the padded prompt's
#: quadratic prefill attention costs more than the launches a graph saves:
#: on an H100 the row-targeted prefill of 1,025 tokens took 77 ms
#: (Phi-3-mini) and 59 ms (Zamba2-1.2B), the replay at rung 2,048 156 and
#: 86 ms (PERF.md §6).
ADMISSION_TOP = 1024


def admission_ladder(cap: int | None) -> tuple[int, ...]:
    """The prompt-length rungs of padded admission for rings of ``cap``
    slots (None: no ring): powers of two from 16 below ``cap``, then
    ``cap`` itself, up to :data:`ADMISSION_TOP`."""
    top = ADMISSION_TOP if cap is None else min(cap, ADMISSION_TOP)
    out, b = [], 16
    while b < top:
        out.append(b)
        b *= 2
    return (*out, top)


def admission_plan(bucket: int, tokens: np.ndarray, row: int) -> np.ndarray:
    """An admission graph's one input, (bucket + 2,) int64: the prompt's
    tokens padded on the right to ``bucket``, its length, its cache row
    (the layout :meth:`TierExecutor._admit_padded` reads)."""
    plan = np.zeros(bucket + 2, np.int64)
    plan[:len(tokens)] = tokens
    plan[bucket], plan[bucket + 1] = len(tokens), row
    return plan


def admission_graphable(cfg: ModelConfig) -> bool:
    """Whether this config's prompts can take padded admission: a text
    trunk whose every block is GQA or Mamba2 with a dense MLP or none.  A
    routed expert's capacity would see the padding, and MLA's prefill has
    not been captured."""
    return cfg.frontend == "none" and all(
        kind.mixer in ("gqa", "mamba") and kind.mlp in ("dense", "none")
        and not kind.cross_attention for _, kind, _ in trunk_layout(cfg))


@dataclasses.dataclass(eq=False)
class _Admission:
    """The admission graphs of one cache layout, one :class:`_Graph` per
    rung (its one static input: the padded tokens, the true length and the
    cache row; its output: the first decode token), sharing one memory
    pool."""

    binding: tuple
    pool: Any
    graphs: dict[int, _Graph] = dataclasses.field(default_factory=dict)


def _leaves(tree):
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (dict, tuple)):
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
    (:func:`repro_torch.models.model.compute_params`).

    ``simulate_network``: after the step's one fetch, sleep each hop's
    transfer over its segment's uplink.  ``overlap``: "serial" pays the
    transfers inline; "pipelined" runs them on per-hop host link clocks
    overlapped with the next step.  ``fault_model`` / ``hop_policy`` arm
    the fault plane (see the module doc).

    ``mesh`` / ``sharding``: run the segments over a device mesh (see the
    module doc's sharded-segment contract).  Params are placed at
    construction; callers place caches through :meth:`shard_caches`.
    ``sharding=None`` derives the policy with
    :func:`~repro_torch.sharding.policy.make_policy`.  A one-device mesh is
    unsharded."""

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
        simulate_network: bool = False,
        overlap: str = "serial",
        fault_model: LinkFaultModel | None = None,
        hop_policy: HopPolicy | None = None,
        mesh: Any = None,
        sharding: Any = None,
    ):
        if compaction not in ("bucketed", "off"):
            raise ValueError(f"unknown compaction mode: {compaction!r}")
        if overlap not in ("serial", "pipelined"):
            raise ValueError(f"unknown overlap mode: {overlap!r}")
        if hint_window < 1:
            raise ValueError(f"hint_window must be >= 1: {hint_window}")
        if bucket_headroom < 0.0:
            raise ValueError(f"bucket_headroom must be >= 0: {bucket_headroom}")
        self.cfg = cfg
        self.device = kernel_ops.resolve_device(device)
        self.mesh = mesh
        self.sharded = mesh is not None and mesh_devices(mesh) > 1
        self.use_kernels = kernel_ops.resolve_use_kernels(
            cfg.use_kernels if use_kernels is None else use_kernels,
            self.device, sharded=self.sharded)
        self.graphs = resolve_graphs(graphs, self.device, sharded=self.sharded)
        params = compute_params(_to_device(params, self.device), compute_dtype(cfg))
        self.policy = None
        if self.sharded:
            self.policy = sharding if sharding is not None else make_policy(mesh, cfg)
            params = self.policy.shard_params(params)
        self.params = params
        self.compaction = compaction
        self.simulate_network = simulate_network
        self.overlap = overlap
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
        #: Pipelined steps paid serially (an overflow re-run, a degraded or
        #: failed step).
        self.pipeline_fallbacks = 0
        #: Pipelined link state: per-hop link-free host clocks, and when the
        #: previous step's last transfer completes.
        self._link_free: list[float] = []
        self._inflight_done = 0.0
        # The fault plane: a policy alone arms a benign model, so timeouts
        # and breakers still apply to the real uplinks.
        if fault_model is None and hop_policy is not None:
            fault_model = LinkFaultModel()
        self.fault_model = fault_model
        self.hop_policy = (hop_policy if hop_policy is not None
                           else HopPolicy() if fault_model is not None else None)
        #: Per-hop circuit breakers by hop index (a tier boundary's position,
        #: which outlives a repartition: a re-solve cannot reset an open
        #: breaker).
        self._breakers: dict[int, CircuitBreaker] = {}
        #: The fault plane's step clock (seeded draws, flap windows).
        self.fault_step = 0
        self.degraded_steps = 0
        self.failed_steps = 0
        self.fault_retries = 0
        #: key -> builds (eager variants, or graph captures) of its decode
        #: segment, and under padded admission with graphs
        #: ``("prefill", rung)`` -> captures of that rung's admission graph,
        #: as the reference's ``("prefill", plen, n)`` jit keys count its
        #: prefill traces.
        self.trace_counts: dict[tuple, int] = {}
        #: key -> graph replays (admission: one per admitted prompt).
        self.replays: dict[tuple, int] = {}
        self._fn_cache: dict[tuple, SegmentFn] = {}
        #: Admission runs each prompt padded to its rung (module doc),
        #: replayed from the rung's graph under graphs.
        self.padded_admission = (self.device.type == "cuda" and not self.sharded
                                 and admission_graphable(cfg))
        self._admission: _Admission | None = None
        self._stream = None  # the capture stream, made at the first capture
        #: A :class:`~repro_torch.serving.trace.Tracer` while tracing; None
        #: = off.
        self.tracer = None
        self.install(segments)

    # -------------------------------------------------------------- plan
    def install(self, segments: Sequence[TierSegment]) -> None:
        """Install a new tier plan, reusing the cached function of every
        segment whose key is unchanged; survivor hints restart at full
        batch.  Pipelined transfers in flight drain first, so no old-plan
        hop overlaps the new plan."""
        self.drain()
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
                    probe: tuple[int, ...] = (), probe_m: int | None = None,
                    degrade: int | None = None) -> SegmentFn:
        """Fetch (or make) the cached function of one tier segment:
        ``bucket=None`` runs the masked full batch, ``bucket=b`` the fused
        compact(b) -> run -> scatter step; ``probe`` adds report-only heads,
        sampled on ``probe_m`` rows when set; ``degrade`` makes it a
        degraded step's terminal segment, finalizing every row not yet
        exited from the head at that layer."""
        key = ((*seg.spec(head), probe, probe_m, degrade), bucket)
        fn = self._fn_cache.get(key)
        if fn is None:
            fn = self._fn_cache[key] = SegmentFn(key, seg, head, bucket, probe,
                                                 probe_m, degrade)
        return fn

    # ---------------------------------------------------------- sharding
    def shard_caches(self, caches: dict) -> dict:
        """Place a freshly initialized cache tree per the policy's cache
        rules (unchanged without a mesh).  Callers run it right after
        ``init_caches``."""
        if not self.sharded:
            return caches
        return self.policy.shard_caches(caches)

    def mesh_context(self):
        """The context a sharded executor's device work runs in: the
        activation-sharding context, with plain tensors meeting DTensors
        counted as replicated.  A null context without a mesh."""
        if not self.sharded:
            return contextlib.nullcontext()
        pol = self.policy
        return shard_ctx.mesh_context(pol.mesh, pol.batch_axes, pol.model_axis)

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
        # Sharded: the logits are gathered whole first, so the entropy, the
        # flag and the first-index argmax are each rank's own, equal plain
        # tensors (as is all of a step's row bookkeeping).
        return decide(shard_ctx.plain(logits), self.cfg.exit_threshold)

    def _head_decisions(self, layers, logits_k: torch.Tensor):
        """Per-head (entropy, raw flag, token) of a (K, B, V) head pile in
        one decision."""
        decide = (kernel_ops.entropy_exit_argmax_heads if self.use_kernels
                  else ref.entropy_exit_argmax_heads_ref)
        # Sharded: the logits are gathered whole first (see _exit_decision).
        e, flag, tok = decide(shard_ctx.plain(logits_k), self.cfg.exit_threshold)
        return {layer: (e[r], flag[r], tok[r]) for r, layer in enumerate(layers)}

    # ------------------------------------------------------------ segment
    def _run_segment(self, fn: SegmentFn, caches, x, pos_t, exited, chosen,
                     probe_rows=None) -> dict[str, Any]:
        """One tier, eagerly: masked full batch (``bucket=None``) or the
        fused compact(bucket) -> run -> scatter step, plus the report-only
        probe heads and a degraded step's fallback head."""
        cfg, params = self.cfg, self.params
        seg, head, bucket = fn.seg, fn.head, fn.bucket
        probe, probe_m, degrade = fn.probe, fn.probe_m, fn.degrade
        plan_set = frozenset(seg.branches)
        # The fallback head joins the plan's stack (and decision).
        stack_set = plan_set | ({degrade} if degrade is not None else set())
        eval_layers = tuple(sorted({*stack_set, *probe}))
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
        h, caches, _, collected = run_trunk(
            params, h, cfg, positions, caches,
            layer_range=(seg.layer_lo, seg.layer_hi), collect=eval_layers,
            rows=rows_rw, use_kernels=self.use_kernels,
        )
        h = shard_ctx.plain(h)  # sharded: the hop's payload, whole on each rank
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
            for got, layers, into in ((collected, stack_set, dec),
                                      (probe_hidden, probe, pdec)):
                ls, lg = branch_logits_stacked(params, got, cfg, tuple(sorted(layers)))
                if lg is not None:
                    into.update(self._head_decisions(ls, lg[:, :, 0]))
        else:
            dec, pdec = [
                {l: self._exit_decision(lg[:, 0])
                 for l, lg in branch_logits_per_head(params, got, cfg).items()}
                for got in ({l: collected[l] for l in stack_set}, probe_hidden)]
        takes, ents, ptakes, pents = [], [], [], []
        for layer in eval_layers:
            if layer in plan_set:
                e, flag, btok = dec[layer]
                take = flag & ~ex
                ch = torch.where(take, btok, ch)
                ex = ex | take
                takes.append(take)
                ents.append(e)
            if layer in probe:  # report-only, never alters the trajectory
                e, flag, _ = pdec[layer]
                ptakes.append(flag & ~(ex if pr_idx is None else ex[pr_idx]))
                pents.append(e)
        if degrade is not None:
            # The link below is broken: every row not yet exited is
            # finalized from the fallback head's argmax (threshold ignored),
            # and the cache clock the absent head tier would bump moves here.
            ch = torch.where(ex, ch, dec[degrade][2])
            ex = torch.ones_like(ex)
            caches["length"] += 1
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
            # Sharded: gathered whole, as the exit heads' (_exit_decision).
            logits = shard_ctx.plain(_unembed(params, hf, cfg)[:, 0])
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
            elif degrade is None:
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
        elif degrade is None:
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
        tr = self.tracer
        if not self.graphs:
            if tr is not None:
                tr.note(mode="eager")
            if var is None:
                fn.variants[sig] = True
                self.trace_counts[fn.key] = self.trace_counts.get(fn.key, 0) + 1
            return self._run_segment(fn, caches, *args)
        if var is not None and var.binding == binding:
            for buf, a in zip(var.inputs, args):
                buf.copy_(a)
            if tr is not None:
                tr.note(mode="replay")
                ev = tr.events_start()
            var.graph.replay()
            if tr is not None:
                tr.events_stop(ev)
            kernel_ops.add_launches(var.launches)
            self.replays[fn.key] = self.replays.get(fn.key, 0) + 1
            return var.out
        if tr is not None:
            tr.note(mode="capture")
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
            with _collector_held(), kernel_ops.recording() as recorded, \
                    torch.cuda.device(self.device), torch.cuda.stream(stream):
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
        """(rings, Mamba2 states) of the caches: the stacked ``self`` dicts
        of the trunk's attention stacks (KV rings; MLA's latent rings) and
        hybrid shared-attention sites, and of its Mamba2 stacks.  Whisper's
        ``cross_kv`` is not among them: decode reads it and never writes
        it, so a re-run needs nothing of it restored."""
        rings, states = [], []
        for name, kind, _n in trunk_layout(self.cfg):
            (rings if kind.mixer in ("gqa", "mla") else states).append(
                caches[name]["self"])
        if hybrid_sites(self.cfg):
            rings.append(caches["shared_attn"]["self"])
        return rings, states

    def _snapshot(self, caches, pos_t):
        """Everything this step can write, per layer and row, plus the
        step counters — what a re-run must restore (see module doc)."""
        rings, states = self._stateful(caches)
        saved = []
        for kv in rings:
            c = kv["pos"].shape[2]
            # Each leaf on this rank's shard (the whole leaf when unsharded):
            # its rows' slots, read and restored in place.
            bufs, idxs = {}, {}
            for k in kv:
                if k == "length":
                    continue
                bufs[k], off = shard_ctx.local_rows(kv[k], dim=1)
                n, bc = bufs[k].shape[:2]
                if pos_t.dim() == 1:
                    slots = (pos_t.long()[off:off + bc] % c)[None, :].expand(n, bc)
                else:
                    slots = (shard_ctx.plain(kv["length"]).long() % c)[:, None].expand(n, bc)
                idxs[k] = (torch.arange(n, device=self.device)[:, None],
                           torch.arange(bc, device=self.device)[None, :], slots)
            saved.append((bufs, idxs, {k: bufs[k][idxs[k]].clone() for k in bufs}))
        for st in states:
            bufs = {k: shard_ctx.local(st[k]) for k in ("conv", "ssm")}
            saved.append((bufs, None, {k: t.clone() for k, t in bufs.items()}))
        lengths = [(t, t.clone()) for t in
                   (caches["length"], *(c["length"] for c in rings + states))]
        return saved, lengths

    @staticmethod
    def _restore(snapshot, caches) -> None:
        saved, lengths = snapshot
        for bufs, idxs, vals in saved:
            for k, v in vals.items():
                if idxs is None:
                    bufs[k].copy_(v)
                else:
                    bufs[k][idxs[k]] = v
        for t, v in lengths:
            t.copy_(v)

    def _traced_snapshot(self, caches, pos_t, tr):
        """:meth:`_snapshot` in a ``tiers.snapshot`` span (on CUDA its
        clones between CUDA events), with the bytes it cloned."""
        sp = tr.open("tiers.snapshot")
        ev = tr.events_start() if self.device.type == "cuda" else None
        snap = saved, lengths = self._snapshot(caches, pos_t)
        if ev is not None:
            tr.events_stop(ev)
        nbytes = (sum(v.nbytes for _, _, vals in saved for v in vals.values())
                  + sum(v.nbytes for _, v in lengths))
        tr.close(sp, bytes=nbytes)
        return snap

    # ---------------------------------------------- buckets and probes
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

    # ------------------------------------------------------- fault plane
    def _plan_hops(self, batch: int
                   ) -> tuple[int | None, dict[int, HopOutcome], tuple[FaultEvent, ...]]:
        """Phase A of the fault plane: check every hop the plan crosses, in
        order, before any segment dispatches (host only, no sync).

        Per hop: the circuit breaker's gate (open and cooling: skip the hop,
        a fast degrade that is not a link observation; open and cooled: one
        half-open attempt), then the policy's attempts against this step's
        draw, the deadline judged on the full-batch payload so the decision
        never depends on the live trajectory.  The first hop that fails
        breaks the chain.  Returns (broken hop or None, the attempted hops'
        outcomes, the step's event trace)."""
        pol, model, step = self.hop_policy, self.fault_model, self.fault_step
        events: list[FaultEvent] = []
        outcomes: dict[int, HopOutcome] = {}
        for j in range(self._head_idx):
            br = self._breakers.setdefault(j, CircuitBreaker(pol))
            gate = br.gate(step)
            if gate == "skip":
                events.append(FaultEvent(step, j, "breaker_skip"))
                return j, outcomes, tuple(events)
            if gate == "probe":
                events.append(FaultEvent(step, j, "breaker_half_open"))
            attempts = 1 if gate == "probe" else 1 + pol.max_retries
            cond, jitter_u, drops = model.draw(step, j, attempts)
            out = attempt_hop(
                pol, cond, drops, jitter_u, step=step, hop=j,
                est_bytes=batch * bytes_per_sequence(self.cfg,
                                                     self.segments[j].layer_hi),
                uplink_bps=self.segments[j].uplink_bps or 0.0, attempts=attempts)
            events.extend(out.events)
            outcomes[j] = out
            self.fault_retries += sum(e.kind == "retry" for e in out.events)
            was = br.state
            br.record(step, out.ok)
            if br.state != was:
                events.append(FaultEvent(step, j, f"breaker_{br.state}"))
            if not out.ok:
                return j, outcomes, tuple(events)
        return None, outcomes, tuple(events)

    def _fallback(self, broken: int) -> tuple[int, int] | None:
        """(segment index, layer) of the deepest exit head at or below the
        broken hop's cut — a branch at the cut, which the healthy plan
        discards, included — or None when there is none."""
        cut = self.segments[broken].layer_hi
        layer = max((b for b in self.cfg.branch_layers if b <= cut), default=0)
        if layer < 1:
            return None
        return next(i for i, s in enumerate(self.segments)
                    if not s.is_empty and s.layer_lo < layer <= s.layer_hi), layer

    # ------------------------------------------------------- link clocks
    def drain(self) -> None:
        """Wait until every pipelined simulated transfer in flight has
        completed, then reset the link clocks (a no-op in serial mode)."""
        wait = max([self._inflight_done, *self._link_free], default=0.0) \
            - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        self._link_free = []
        self._inflight_done = 0.0

    def _pipeline_transfers(self, sim: tuple[float, ...]) -> None:
        """Schedule this step's hop transfers on the per-hop link clocks and
        return once the *previous* step's transfers have drained, so the
        steady step period is the pipeline's slowest stage."""
        now = time.perf_counter()
        self._link_free += [0.0] * (len(sim) - len(self._link_free))
        arrive = now  # the payload leaves the entry tier at the fetch
        for j, t in enumerate(sim):
            # Hop j takes the payload once it has cleared hop j-1 and the
            # link has finished the previous token's transfer.
            self._link_free[j] = max(arrive, self._link_free[j]) + t
            arrive = self._link_free[j]
        prev_done, self._inflight_done = self._inflight_done, arrive
        wait = prev_done - time.perf_counter()
        if wait > 0:
            time.sleep(wait)

    def _transfers(self, nbytes, outcomes: dict[int, HopOutcome]
                   ) -> tuple[float, ...]:
        """Each hop's simulated seconds: its bytes over its uplink, or under
        the fault plane the (multiplier-scaled, spike-added) transfer of a
        hop that held plus the overhead its failed attempts burned."""
        sim = []
        for j, nb in enumerate(nbytes):
            up = self.segments[j].uplink_bps
            o = outcomes.get(j)
            if o is None:
                if nb > 0 and (not up or up <= 0.0):
                    raise LinkDownError(
                        f"hop {j} ({self.segments[j].name}) must ship {nb:.0f} "
                        "bytes but uplink_bps is unset/zero; attach a "
                        "LinkFaultModel to degrade instead")
                sim.append(transfer_seconds(nb, up))
            else:
                t = (o.latency_s + nb * 8.0 / (up * o.bandwidth_mult)
                     if o.ok and nb > 0 else 0.0)
                sim.append(o.overhead_s + t)
        return tuple(sim)

    def _pay(self, sim: tuple[float, ...], pipelined: bool) -> None:
        """Charge the step's simulated transfers to the wall clock: on the
        link clocks, or inline (a pipelined executor drains first and
        counts the fallback)."""
        if pipelined:
            self._pipeline_transfers(sim)
            return
        if self.overlap == "pipelined":
            self.pipeline_fallbacks += 1
            self.drain()
        if sum(sim) > 0:
            time.sleep(sum(sim))

    # -------------------------------------------------------------- step
    def dispatch(self, tok, pos_t, caches, buckets: dict[int, int],
                 exited0: torch.Tensor | None = None, probe_map=None,
                 probe_rows: torch.Tensor | None = None, probe_m: int | None = None,
                 degrade: tuple[int, int] | None = None):
        """Enqueue every tier segment of one step; no host sync.  Returns
        (tensors to fetch, chosen tokens, main-head logits); under graphs
        they are graph outputs, valid until the segments replay again.
        ``degrade=(segment index, layer)`` ends the step at that segment,
        which finalizes every row from the head at that layer."""
        probe_map = probe_map or {}
        batch = tok.shape[0]
        exited = (torch.zeros((batch,), dtype=torch.bool, device=self.device)
                  if exited0 is None else exited0)
        chosen = torch.zeros((batch,), dtype=torch.int32, device=self.device)
        layout = self._layout(caches)
        x = tok
        fetch: dict[str, torch.Tensor] = {}
        logits = None
        last = len(self.segments) if degrade is None else degrade[0] + 1
        for i, seg in enumerate(self.segments[:last]):
            if seg.is_empty:
                continue
            head = i == self._head_idx
            b = buckets.get(i)
            pr = probe_map.get(i, ())
            sampled = bool(pr) and probe_m is not None
            deg = degrade[1] if degrade is not None and i == degrade[0] else None
            fn = self._segment_fn(seg, head, None if b is None else min(b, batch),
                                  pr, probe_m if sampled else None, deg)
            tr = self.tracer
            sp = (None if tr is None else tr.open(
                "tiers.segment", index=i, bucket=batch if fn.bucket is None else fn.bucket))
            out = self.call_segment(fn, x, pos_t, exited, chosen, caches, layout,
                                    probe_rows if sampled else None)
            if tr is not None:
                tr.close(sp)
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
            elif deg is None:
                x = out["hidden"]
        fetch["tokens"] = chosen
        fetch["exited"] = exited
        if self.sharded:
            # The step's outputs, whole on every rank, before the one fetch.
            fetch = {k: shard_ctx.plain(t) for k, t in fetch.items()}
            chosen, logits = fetch["tokens"], shard_ctx.plain(logits)
        return fetch, chosen, logits

    def _run_once(self, tok, pos_t, caches, buckets, exited0, active_np,
                  probe_map, probe_rows, probe_m, degrade):
        """Dispatch the segments and make the single fetch; returns (host
        dict, entering-survivor counts, chosen, logits, alive counts, the
        rows exited before the step or at a plan branch).  Segments past
        a degraded step's end have no masks: their counts carry the last
        executed segment's."""
        batch = tok.shape[0]
        fetch, chosen, logits = self.dispatch(tok, pos_t, caches, buckets,
                                              exited0, probe_map, probe_rows,
                                              probe_m, degrade)
        tr = self.tracer
        sp = None if tr is None else tr.open("tiers.fetch")
        host = self._fetch(fetch)
        if tr is not None:
            tr.close(sp)
        exited_run = (np.zeros((batch,), bool) if active_np is None
                      else ~active_np)
        alive_after_seg = {}
        for i, seg in enumerate(self.segments):
            if f"take{i}" in host:
                for row in range(len(seg.branches)):
                    exited_run |= host[f"take{i}"][row]
            alive_after_seg[i] = int(batch - exited_run.sum())
        last = len(self.segments) if degrade is None else degrade[0] + 1
        entering = {
            i: alive_after_seg[i - 1]
            for i in range(1, last)
            if not self.segments[i].is_empty
        }
        return host, entering, chosen, logits, alive_after_seg, exited_run

    def _failed_step(self, batch: int, active_np, live: int, outcomes,
                     events, broken: int) -> TierStepResult:
        """A broken hop with no exit head at or below it: nothing runs and
        nothing is fetched; every live row fails.  Under
        ``simulate_network`` only the overhead of the failed attempts is
        charged (no payload left the entry tier)."""
        self.failed_steps += 1
        sim = ()
        if self.simulate_network:
            sim = tuple(outcomes[j].overhead_s if j in outcomes else 0.0
                        for j in range(self._head_idx))
            self._pay(sim, pipelined=False)
        hops = self._head_idx
        return TierStepResult(
            tokens=np.zeros((batch,), np.int32),
            exited=(np.zeros((batch,), bool) if active_np is None else ~active_np),
            exit_tier=np.full((batch,), -1, np.int32),
            branch_take={},
            branch_entropy={},
            shipped_per_hop=(0,) * hops,
            bytes_per_hop=(0.0,) * hops,
            tokens_dev=torch.zeros((batch,), dtype=torch.int32, device=self.device),
            last_logits=None,
            compaction=tuple(HopCompaction(0, 0) for _ in range(hops)),
            sim_transfer_s=sim,
            live=live,
            active=active_np,
            degraded=np.zeros((batch,), bool),
            failed=(np.ones((batch,), bool) if active_np is None
                    else active_np.copy()),
            fault_events=events,
            degraded_hop=broken,
        )

    def step(self, tok, pos, caches: dict, *, active=None
             ) -> tuple[TierStepResult, dict]:
        """One decode step across all tiers: one host sync (plus one per
        rare overflow re-run; none on a failed step).  ``tok`` (B, 1)
        tokens (on the device, or host values); ``pos`` the shared step
        position or a per-sequence (B,) vector; ``active`` (B,) marks live
        slots (dead slots enter pre-exited)."""
        tr = self.tracer
        sp = None
        if tr is not None:
            sp = tr.open("tiers.step")
            if self.device.type == "cuda":
                tr.stream = torch.cuda.current_stream(self.device)
        try:
            with self.mesh_context():
                return self._step(tok, pos, caches, active, tr)
        finally:
            if tr is not None:
                tr.close(sp)

    def _step(self, tok, pos, caches: dict, active, tr) -> tuple[TierStepResult, dict]:
        cfg = self.cfg
        batch = tok.shape[0]
        active_np = None if active is None else np.array(active, dtype=bool)
        live = batch if active_np is None else int(active_np.sum())
        # The fault plane's phase A, before anything reaches the device.
        broken, outcomes, events, degrade = None, {}, (), None
        if self.fault_model is not None:
            broken, outcomes, events = self._plan_hops(batch)
            self.fault_step += 1
            if broken is not None:
                self.degraded_steps += 1
                degrade = self._fallback(broken)
                if degrade is None:
                    return self._failed_step(batch, active_np, live, outcomes,
                                             events, broken), caches
        sp = None if tr is None else tr.open("tiers.plan")
        tok = self._upload(tok, torch.int32)
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
        if tr is not None:
            tr.close(sp)
        snap = None
        if any(b < batch for b in buckets.values()):
            snap = (self._snapshot(caches, pos_t) if tr is None
                    else self._traced_snapshot(caches, pos_t, tr))
        run = (tok, pos_t, caches)
        extra = (exited0, active_np, probe_map, probe_rows, probe_m, degrade)
        host, entering, chosen, logits, alive, exited_plan = self._run_once(
            *run, buckets, *extra)
        used = {i: min(buckets.get(i, batch), batch) for i in entering}
        # Overflow: true survivors exceeded a planned bucket, so excluded
        # survivors carry garbage.  Restore the entry state and re-run with
        # measured buckets (non-decreasing, so this ends in <= K runs; the
        # last resort is full-batch buckets).
        attempts = 0
        while any(entering[i] > used[i] for i in entering):
            sp = None if tr is None else tr.open("tiers.rerun")
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
            host, entering, chosen, logits, alive, exited_plan = self._run_once(
                *run, buckets, *extra)
            used = {i: min(buckets.get(i, batch), batch) for i in entering}
            if tr is not None:
                tr.close(sp)
        if tr is not None:
            tr.open("tiers.report")  # closed with tiers.step
        self._observe_hints(entering)
        if self.graphs:
            # Graph outputs are rewritten by the next replay: the step's
            # device results leave it as copies of their own.
            chosen = chosen.clone()
            logits = None if logits is None else logits.clone()

        # Probe branches report would-exit masks and entropies only; they
        # never touch exit_tier.  A degraded step has no masks past its end.
        exit_tier = np.full((batch,), -1, np.int32)
        branch_take: dict[int, np.ndarray] = {}
        branch_entropy: dict[int, np.ndarray] = {}
        branch_probe_mask: dict[int, np.ndarray] = {}
        for i, seg in enumerate(self.segments):
            if f"take{i}" in host:
                for row, layer in enumerate(seg.branches):
                    mask = host[f"take{i}"][row]
                    branch_take[layer] = mask
                    branch_entropy[layer] = host[f"ents{i}"][row]
                    exit_tier[mask] = i
            if f"ptake{i}" in host:
                for row, layer in enumerate(probe_map.get(i, ())):
                    branch_take[layer] = host[f"ptake{i}"][row]
                    branch_entropy[layer] = host[f"pents{i}"][row]
                    if probe_m is not None:
                        branch_probe_mask[layer] = host[f"pcover{i}"]

        # Degraded rows: exited in the fetch but at no plan branch — the
        # fallback head finalized them.  Their exit tier is the fallback
        # tier; they stay out of branch_take, so exit-probability
        # estimates see only threshold exits.
        degraded = failed = None
        if broken is not None:
            degraded = host["exited"] & ~exited_plan
            exit_tier[degraded] = degrade[0]
            failed = np.zeros((batch,), bool)

        # One hop per cut with layers (or the head) downstream; a degraded
        # step ships nothing from its fallback segment on.
        stop_hop = self._head_idx if degrade is None else degrade[0]
        shipped, nbytes, compaction = [], [], []
        for j in range(self._head_idx):
            if j >= stop_hop:
                shipped.append(0)
                nbytes.append(0.0)
                compaction.append(HopCompaction(0, 0))
                continue
            alive_j = alive[j]
            shipped.append(alive_j)
            nbytes.append(alive_j * bytes_per_sequence(cfg, self.segments[j].layer_hi))
            nxt = next(i for i in range(j + 1, len(self.segments))
                       if not self.segments[i].is_empty)
            compaction.append(HopCompaction(alive_j, used.get(nxt, batch)))

        sim = ()
        if self.simulate_network:
            sim = self._transfers(nbytes, outcomes)
            self._pay(sim, self.overlap == "pipelined" and attempts == 0
                      and broken is None)

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
            sim_transfer_s=sim,
            live=live,
            active=active_np,
            branch_probe_mask=branch_probe_mask,
            degraded=degraded,
            failed=failed,
            fault_events=events,
            degraded_hop=broken,
        )
        return result, caches

    # ------------------------------------------------- request admission
    def prefill_rows(self, caches: dict, tokens, rows) -> tuple[dict, torch.Tensor]:
        """Admit a block of prompts into cache rows in place: prompt row i
        prefills row ``rows[i]``, ending exactly as a fresh solo prefill.
        ``rows`` is a host-side plan; sentinel rows (>= batch) drop.  Under
        padded admission (module doc) each real row runs its rung's body,
        replayed from the rung's graph under graphs, and a sentinel row
        runs nothing (its token is 0); else the block runs as one
        row-targeted prefill.  Returns (caches, first decode input token
        per prompt row (n,), on the device — no device-to-host sync).  An
        ``audio`` trunk raises, as the reference's row-targeted prefill
        does: its encoder output is per batch."""
        tokens = np.asarray(tokens)
        rows = np.asarray(rows, np.int64)
        plen = tokens.shape[1]
        if self.padded_admission:
            slots, rungs = self.admission_rungs(caches)
            bucket = next((b for b in rungs if b >= plen), None)
            if bucket is not None:
                return caches, self._admit_padded_rows(caches, tokens, rows, rungs,
                                                       bucket, slots)
        if self.tracer is not None:
            self.tracer.note(mode="eager", bucket=plen)
        toks = self._upload(tokens, torch.int64)
        with self.mesh_context():
            logits, caches = prefill(self.params, toks, self.cfg, caches,
                                     rows=rows, use_kernels=self.use_kernels)
            return caches, shard_ctx.plain(logits[:, 0]).argmax(-1).to(torch.int32)

    def admission_rungs(self, caches) -> tuple[int, tuple[int, ...]]:
        """(the caches' batch, the rungs of padded admission into them:
        :func:`admission_ladder` of their rings' capacity).  A prompt longer
        than the last rung takes the row-targeted prefill."""
        rings, states = self._stateful(caches)
        if rings:
            return rings[0]["pos"].shape[1], admission_ladder(rings[0]["pos"].shape[2])
        return states[0]["ssm"].shape[1], admission_ladder(None)

    def _admit_padded_rows(self, caches, tokens: np.ndarray, rows: np.ndarray,
                           rungs: tuple[int, ...], bucket: int, slots: int) -> torch.Tensor:
        """Padded admission: each real row fills one pinned buffer (its
        tokens padded to ``bucket``, its length, its row) and uploads it
        without blocking; under graphs into the rung's static input, then
        replays (the first call on a cache layout captures every rung of
        the ladder), else into the body called directly.  The row's first
        token is copied into its place."""
        g = None
        if self.graphs:
            _, binding = self._layout(caches)
            adm = self._admission
            if adm is None or adm.binding != binding:
                adm = self._admission = _Admission(binding, torch.cuda.graph_pool_handle())
            missing = [b for b in rungs if b not in adm.graphs]
            if self.tracer is not None:
                self.tracer.note(mode="capture" if missing else "replay", bucket=bucket)
            if missing:
                self._capture_admission(caches, adm, missing, slots)
            g, key = adm.graphs[bucket], ("prefill", bucket)
        elif self.tracer is not None:
            self.tracer.note(mode="eager", bucket=bucket)
        out = torch.zeros(len(rows), dtype=torch.int32, device=self.device)
        for i in np.flatnonzero(rows < slots):
            plan = torch.from_numpy(admission_plan(bucket, tokens[i], rows[i])).pin_memory()
            if g is None:
                out[i:i + 1] = self._admit_padded(
                    caches, plan.to(self.device, non_blocking=True), bucket)
                continue
            g.inputs[0].copy_(plan, non_blocking=True)
            g.graph.replay()
            kernel_ops.add_launches(g.launches)
            self.replays[key] = self.replays.get(key, 0) + 1
            out[i:i + 1].copy_(g.out)
        return out

    def _admit_padded(self, caches, plan: torch.Tensor, bucket: int) -> torch.Tensor:
        """The admission body of one rung: the prefill of ``plan``'s prompt
        (:class:`~repro_torch.models.attention.PaddedPrompt`), returning its
        first decode token (1,)."""
        toks = plan[:bucket].view(1, bucket)
        logits, _ = prefill(self.params, toks, self.cfg, caches,
                            rows=PaddedPrompt(plan[bucket + 1:], plan[bucket:bucket + 1]),
                            use_kernels=self.use_kernels)
        return logits[:, 0].argmax(-1).to(torch.int32)

    def _capture_admission(self, caches, adm: _Admission, rungs, slots: int) -> None:
        """Capture each rung on a sentinel row, so that nothing writes a
        cache row.  The first rung runs eagerly on the capture stream
        before its capture, as :meth:`_capture` does for a segment (it
        loads the kernels and settles cuBLAS); the later rungs, whose calls
        differ only in shapes, are captured directly (on an H100, a warm-up
        for each of Phi-3-mini's nine rungs to 4,096 cost ~1.3 s more set-up
        and gave the same rows and tokens).  Each capture holds Python's
        collector off (:func:`_collector_held`).  A capture that fails
        raises."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        stream, cur = self._stream, torch.cuda.current_stream(self.device)
        for n, b in enumerate(rungs):
            plan = admission_plan(b, np.zeros(b, np.int64), slots)
            static = torch.from_numpy(plan).pin_memory().to(self.device, non_blocking=True)
            stream.wait_stream(cur)
            if n == 0:
                with torch.cuda.stream(stream):
                    self._admit_padded(caches, static, b)
            graph = torch.cuda.CUDAGraph()
            try:
                with _collector_held(), kernel_ops.recording() as recorded, \
                        torch.cuda.device(self.device), torch.cuda.stream(stream):
                    graph.capture_begin(pool=adm.pool)
                    try:
                        out = self._admit_padded(caches, static, b)
                    finally:
                        graph.capture_end()
            except RuntimeError as e:
                raise RuntimeError(
                    f"capturing the admission graph of rung {b} failed") from e
            cur.wait_stream(stream)
            adm.graphs[b] = _Graph(adm.binding, graph, (static,), out, recorded)
            key = ("prefill", b)
            self.trace_counts[key] = self.trace_counts.get(key, 0) + 1

    def reset_rows(self, caches: dict, rows) -> dict:
        """Mark cache rows empty without moving K/V: ring slot validity
        (``pos``) -> -1, Mamba2 conv window and SSM state -> 0; sentinel
        rows (>= batch) are ignored.  Runs eagerly.  An ``audio`` trunk
        raises (see :meth:`prefill_rows`)."""
        if self.cfg.arch_type == "audio":
            raise NotImplementedError(
                "reset_rows: row-targeted admission does not cover encoder "
                "cross-KV caches")
        rows = np.asarray(rows, np.int64)
        rings, states = self._stateful(caches)
        for buf, key, fill in ([(kv, "pos", -1) for kv in rings]
                               + [(st, k, 0) for st in states
                                  for k in ("conv", "ssm")]):
            # This rank's shard of the leaf (the whole leaf when unsharded).
            t, off = shard_ctx.local_rows(buf[key], dim=1)
            keep = rows[(rows >= off) & (rows < off + t.shape[1])] - off
            if keep.size:
                t[:, torch.as_tensor(keep, device=self.device)] = fill
        return caches


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)
