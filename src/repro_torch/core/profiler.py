"""Per-layer cost extraction: the partitioner's ``t_c`` / ``alpha`` inputs —
counterpart of ``repro.core.profiler``.

The paper measures ``t_i^c`` on Google Colab (K80) and sets
``t_i^e = gamma * t_i^c``.  Two sources:

  * :func:`measure_layer_times` — time each layer callable on its device:
    on CUDA, ``iters`` replays of the layer captured as a CUDA graph
    between two CUDA events (the reference jits each layer to time
    steady-state compute; eager calls would time the host's dispatch);
    on the CPU, ``perf_counter`` around the (synchronous) calls;
  * :func:`analyze_layer_costs` — roofline times from two counters of each
    layer's aten ops, t = max(flops / peak, bytes / bw): FLOPs from
    ``torch.utils.flop_counter.FlopCounterMode`` (the matmul-class ops),
    bytes from :class:`_ByteCounter` (every aten op's input and output
    bytes, view ops left out).  The reference reads both from XLA's
    ``cost_analysis()`` of the compiled layer; these counts are unfused (a
    tensor one op writes and the next reads counts twice), and the FLOP
    count leaves out elementwise work, which XLA adds.

:func:`profile_decode_layers` builds the serving-relevant inputs for
either source directly from a BranchyNet trunk: one decode-step callable
per trunk layer (its residual update *including* the resident-cache
read/write), dispatched through the same ``use_kernels`` resolution as the
tier runtime — so measure mode on the card times the Hopper
``flash_decode`` / ``ssd_update`` kernels the runtime launches, replayed
from each layer's captured graph.  Neither
counter can see inside a kernel launched through ctypes, so analyze mode
always counts the layer's plain PyTorch lowering, which computes the same
function.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

__all__ = [
    "HardwareSpec",
    "H100_SXM",
    "LayerCost",
    "analyze_layer_costs",
    "branch_head_cost",
    "capture_layer",
    "decode_layer_fns",
    "measure_layer_times",
    "output_bytes",
    "profile_decode_layers",
]


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Roofline constants for one accelerator tier."""

    name: str
    peak_flops: float  # FLOP/s (bf16 unless noted)
    hbm_bw: float  # bytes/s
    link_bw: float  # bytes/s per direction of the link between devices
    hbm_bytes: float

    def roofline_time(
        self, flops: float, bytes_: float, devices: int = 1
    ) -> float:
        """Execution time lower bound: max of compute and memory terms.

        ``devices > 1`` models a tensor-parallel shard of the layer: FLOPs
        and memory traffic split across the shard width; the collective
        cost of re-assembling the activation is priced separately by
        :func:`collective_time`."""
        d = max(int(devices), 1)
        return max(flops / d / self.peak_flops, bytes_ / d / self.hbm_bw)

    def collective_time(self, activation_bytes: float, devices: int) -> float:
        """Per-layer intra-tier collective term: a ring all-reduce of the
        layer's activation over the device link, twice per layer
        (attention-out + MLP-down partial sums) — the profiler-side mirror
        of ``repro_torch.core.multitier._collective_seconds``."""
        d = max(int(devices), 1)
        if d <= 1 or activation_bytes <= 0.0:
            return 0.0
        return 2.0 * (2.0 * (d - 1) / d) * activation_bytes / self.link_bw


#: One NVIDIA H100 SXM5 at its 700 W limit (NVIDIA H100 Tensor Core GPU
#: datasheet): dense bf16 tensor-core peak, HBM3 rate, NVLink 4 per
#: direction, device memory.
H100_SXM = HardwareSpec(
    "h100-sxm", peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9, hbm_bytes=80e9
)


@dataclasses.dataclass(frozen=True)
class LayerCost:
    name: str
    flops: float
    bytes_accessed: float
    output_bytes: float
    time_s: float


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def output_bytes(tree) -> float:
    """Total bytes of the tensors in a nested dict / list / tuple (the
    paper's alpha_i for the tensor that crosses the cut)."""
    return float(sum(t.numel() * t.element_size() for t in _tensors(tree)))


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's distinct input and output tensors
    (a tensor updated in place counts once), leaving out view ops, which
    move no data."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            seen = {id(t): t for t in _tensors((args, kwargs or {}, out))}
            self.bytes += sum(t.numel() * t.element_size() for t in seen.values())
        return out


def analyze_layer_costs(
    layer_fns: Sequence[tuple[str, Callable]],
    layer_inputs: Sequence,
    hardware: HardwareSpec = H100_SXM,
    *,
    devices: int = 1,
) -> list[LayerCost]:
    """Roofline-cost every layer of a chain from its aten ops.

    ``layer_fns[i]`` maps layer i's input (a tensor or a nested container
    of them) to its output; it runs once, on ``layer_inputs[i]``, under the
    FLOP and byte counters.  Only PyTorch ops are seen: a callable that
    launches a ctypes kernel must be given in its plain lowering.

    ``devices > 1`` prices a mesh-sharded tier: each layer's roofline time
    divides by the shard width and gains the per-layer collective term
    (``HardwareSpec.collective_time`` on the layer's output activation),
    the same two terms ``TierSpec(devices=, ici_bps=)`` carries into
    :func:`repro_torch.core.multitier.solve_multitier`.
    """
    out: list[LayerCost] = []
    for (name, fn), args in zip(layer_fns, layer_inputs):
        flop_counter = FlopCounterMode(display=False)
        byte_counter = _ByteCounter()
        with flop_counter, byte_counter:
            res = fn(args)
        flops = float(flop_counter.get_total_flops())
        nbytes = float(byte_counter.bytes)
        ob = output_bytes(res)
        t = hardware.roofline_time(flops, max(nbytes, ob), devices)
        t += hardware.collective_time(ob, devices)
        out.append(LayerCost(name, flops, nbytes, ob, t))
    return out


def capture_layer(fn: Callable, args, warmup: int):
    """``fn(args)`` captured as a ``torch.cuda.CUDAGraph``: ``warmup``
    eager calls on a side stream first (the capture recipe's warmup, which
    also settles cuBLAS / cuDNN workspaces and loads the kernels), then
    one call captured into the graph's own memory pool, freed with the
    graph.  Returns (graph, static output): each ``graph.replay()`` reruns
    the captured kernels on the same buffers and rewrites the static
    output.  Raises if the capture fails (a host sync or an operation that
    capture refuses inside ``fn``)."""
    device = next(_tensors(args)).device
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn(args)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(graph):
        out = fn(args)
    return graph, out


def measure_layer_times(
    layer_fns: Sequence[tuple[str, Callable]],
    layer_inputs: Sequence,
    iters: int = 10,
    warmup: int = 2,
) -> list[LayerCost]:
    """Mean time of one call of each layer on its inputs' device (paper
    Sec. VI mode).

    CUDA inputs: the layer is captured once as a CUDA graph after
    ``warmup`` eager calls (:func:`capture_layer`), replayed once untimed
    (the first launch uploads the graph), and ``iters`` replays are timed
    between two CUDA events — the layer's kernels back to back, without
    the host's per-op dispatch, as the reference times a jitted layer.  A
    layer that updates state in place (a KV slot, an SSM state) redoes
    that update on every replay, on the same buffers: that is the work the
    layer does.  ``output_bytes`` is read from the graph's static output,
    and the graph and its pool are freed before the next layer.  A capture
    failure raises; there is no eager timing on CUDA.

    CPU inputs: ``warmup`` calls, then ``iters`` calls between two
    ``perf_counter`` readings (the CPU's ops return when done)."""
    out: list[LayerCost] = []
    for (name, fn), args in zip(layer_fns, layer_inputs):
        device = next(_tensors(args)).device
        if device.type == "cuda":
            try:
                graph, res = capture_layer(fn, args, warmup)
            except RuntimeError as e:
                raise RuntimeError(
                    f"measure mode: capturing {name} as a CUDA graph failed") from e
            graph.replay()
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                graph.replay()
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / iters
            ob = output_bytes(res)
            del graph, res
        else:
            for _ in range(warmup):
                fn(args)
            t0 = time.perf_counter()
            for _ in range(iters):
                res = fn(args)
            dt = (time.perf_counter() - t0) / iters
            ob = output_bytes(res)
        out.append(LayerCost(name, 0.0, 0.0, ob, dt))
    return out


# ------------------------------------------------- branch-head pricing
def branch_head_cost(
    cfg,
    batch: int,
    *,
    heads_batched: bool = True,
    hardware: HardwareSpec = H100_SXM,
):
    """Roofline seconds to evaluate ``m`` tied exit heads in one decode
    step at the cloud-reference tier: per-branch norm + the shared
    (D, V) unembedding applied to a (batch, D) hidden per head.

    Returns a callable ``m -> seconds`` (``m = 0`` is free) — the
    ``head_cost=`` input of :func:`repro_torch.core.multitier.
    solve_multitier` / ``expected_time_multitier`` and both servers'
    ``est_latency_s``.

    ``heads_batched=True`` prices the runtime's stacked evaluation
    (``TierExecutor(batched_heads=True)``, the default): FLOPs still scale
    with ``m``, but the dominant memory term — streaming the D x V
    unembedding weight — is paid ONCE for the whole stack, so ``m`` heads
    cost about one head's bandwidth.  ``heads_batched=False`` prices the
    sequential per-head lowering: ``m`` independent projections, each
    re-reading the weight.
    """
    d = float(cfg.d_model)
    v = float(cfg.padded_vocab_size)
    b = float(batch)
    itemsize = 2.0 if cfg.dtype == "bfloat16" else 4.0
    w_bytes = d * v * itemsize  # the shared unembedding read
    act_bytes = b * (d + v) * itemsize  # per-head hidden read + logits write
    flops_per_head = 2.0 * b * d * v

    def cost(m: int) -> float:
        m = int(m)
        if m <= 0:
            return 0.0
        if heads_batched:
            return hardware.roofline_time(
                m * flops_per_head, w_bytes + m * act_bytes
            )
        return m * hardware.roofline_time(flops_per_head, w_bytes + act_bytes)

    return cost


# ------------------------------------------------- serving decode profiles
def _rings(tree):
    """The ring dicts in a caches tree: KV rings (k, v, pos, length) and
    MLA's latent rings (ckv, k_rope, pos, length)."""
    if isinstance(tree, dict):
        if "pos" in tree:
            yield tree
        else:
            for v in tree.values():
                yield from _rings(v)


def _fill_rings(caches: dict, pos: int) -> None:
    """Make every KV ring of ``caches`` hold the ``pos`` positions before
    the query (slot ``p % C`` holds position ``p``; the newest ``C`` when
    the ring is shorter), as after an admission of that length."""
    for kv in _rings(caches):
        c = kv["pos"].shape[-1]
        p = torch.arange(max(0, pos - c), pos, dtype=torch.int32,
                         device=kv["pos"].device)
        kv["pos"][..., (p % c).long()] = p
        kv["length"].fill_(pos)


def decode_layer_fns(
    cfg,
    params,
    batch: int,
    context_len: int,
    *,
    use_kernels: bool | None = None,
    pos: int | None = None,
) -> tuple[list[tuple[str, Callable]], list]:
    """Per-trunk-layer decode-step callables + their inputs.

    Layer ``i``'s callable maps ``(h (B, 1, d), caches)`` to the residual
    stream after layer ``i`` — including the layer's resident-cache
    read/write, and for a hybrid trunk the shared attention block when
    layer ``i`` ends at one of its sites — through
    :func:`repro_torch.models.model.run_trunk` with the SAME
    ``use_kernels`` resolution the tier runtime uses (None = the config's,
    then kernels on a CUDA device, plain versions on the CPU).  Every
    layer shares one set of caches on the params' device, updated in place
    by each call.

    The query sits at ``pos`` (default mid-context) with the ``pos``
    earlier positions in every KV ring.  The reference profiles over empty
    rings, which its Pallas kernel reads whole anyway; the port's
    ``flash_decode`` reads the valid slots only, so an empty ring would
    price attention at almost nothing.  A Whisper decoder layer's caches
    carry the (zero) cross K/V over every encoder frame, as the
    reference's ``init_caches`` does, so both modes price its
    cross-attention over all ``encoder_seq_len`` frames.

    ``output_bytes`` of each callable is the residual stream — the
    paper's per-layer ``alpha_i`` — because the cache stays resident and
    never crosses a cut.
    """
    # Deferred: the model stack imports repro_torch.core submodules.
    from repro_torch.kernels.ops import resolve_use_kernels
    from repro_torch.models import model as M

    device = next(_tensors(params)).device
    kernels = resolve_use_kernels(
        cfg.use_kernels if use_kernels is None else use_kernels, device
    )
    total = sum(n for _, _, n in M.trunk_layout(cfg))
    dtype = M.compute_dtype(cfg)
    params = M.compute_params(params, dtype)
    pos = context_len // 2 if pos is None else pos
    positions = torch.full((1,), pos, dtype=torch.int32, device=device)

    def make_fn(i: int) -> Callable:
        def fn(args):
            h, caches = args
            h2, _, _, _ = M.run_trunk(
                params, h, cfg, positions, caches,
                layer_range=(i, i + 1), use_kernels=kernels,
            )
            return h2

        return fn

    fns = [(f"layer{i + 1}", make_fn(i)) for i in range(total)]
    h0 = torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device)
    caches = M.init_caches(cfg, batch, context_len, device=device)
    _fill_rings(caches, pos)
    return fns, [(h0, caches)] * total


def profile_decode_layers(
    cfg,
    params,
    batch: int,
    context_len: int,
    *,
    use_kernels: bool | None = None,
    mode: str = "analyze",
    hardware: HardwareSpec = H100_SXM,
    iters: int = 10,
    warmup: int = 2,
    devices: int = 1,
) -> list[LayerCost]:
    """Per-layer decode-step costs of a BranchyNet trunk.

    ``mode="measure"`` times each layer as the tier runtime runs it
    (``use_kernels`` resolved as there: the Hopper kernels on the card),
    as CUDA-graph replays on the card (:func:`measure_layer_times`);
    ``mode="analyze"`` rooflines each layer's plain PyTorch lowering
    (whatever ``use_kernels`` says: the counters cannot see into a
    kernel), running each layer once.  Either way the resulting ``t_c``
    feeds :class:`~repro_torch.core.types.CostProfile`.

    ``devices > 1`` prices the layers as a mesh-sharded tier runs them:
    ``use_kernels`` resolves to the plain versions (a sharded segment takes
    them), analyze mode rooflines over the shard width plus the per-layer
    collective term (:func:`analyze_layer_costs`), and measure mode times
    the plain path on this one device and does not divide, as the
    reference's measure mode does."""
    from repro_torch.kernels.ops import resolve_use_kernels

    if mode not in ("analyze", "measure"):
        raise ValueError(f"unknown profiling mode: {mode!r}")
    if devices > 1:
        use_kernels = resolve_use_kernels(use_kernels, None, sharded=True)
    if mode == "analyze":
        fns, inputs = decode_layer_fns(cfg, params, batch, context_len,
                                       use_kernels=False)
        return analyze_layer_costs(fns, inputs, hardware, devices=devices)
    fns, inputs = decode_layer_fns(cfg, params, batch, context_len,
                                   use_kernels=use_kernels)
    return measure_layer_times(fns, inputs, iters=iters, warmup=warmup)
