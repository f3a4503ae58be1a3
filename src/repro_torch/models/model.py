"""BranchyModel for the dense GQA, routed-expert (``moe``: Qwen3-30B-A3B;
DeepSeek-V3's MLA trunk of a dense stack then an MoE stack), vision-language (``vlm``: InternVL2's language trunk), Mamba2 (``ssm``),
Zamba2 (``hybrid``) and encoder-decoder (``audio``: Whisper) trunks:
backbone + tied side branches, with prefill / decode entry points —
counterpart of ``repro.models.model``.

An ``audio`` trunk is Whisper's decoder: GQA blocks without RoPE, each
with a cross-attention block over the encoder's output, and a GELU MLP;
sinusoidal absolute positions are added to the token embeddings (the
float64 table at prefill, fp32 device math at decode, as in the
reference).  The encoder (``params["encoder"]``, ``params["enc_norm"]``)
runs once per batch over precomputed frame embeddings (the conv frontend
is a stub in the reference too) at admission, and every decoder layer's
cross K/V is kept beside the self-attention rings (``caches["cross_kv"]``),
read, never written, by decode.  The reference's encoder blocks mask
causally although Whisper's attend both ways (its ``causal=False`` only
drops the sliding window); the port does the same.

A ``vlm`` trunk is the dense GQA stack; its prompts start with
``num_patches`` precomputed patch embeddings (the vision frontend is a stub
in the reference too), prepended to the token embeddings in the compute
dtype.  Training drops the patch positions' logits from every head's loss.

Trunk layers are numbered 1..L like the paper's ``v_i``; side branches sit
after the layers in ``cfg.branch_layers`` and are collected by
``run_trunk(collect=...)``.  Branch heads are tied to the main LM head
(per-branch norm + shared unembedding), as in the reference.

A hybrid trunk runs one shared attention block (``params["shared_attn"]``,
its own KV cache per site) after every ``attn_every``-th Mamba2 layer
(:func:`hybrid_sites`).

Params (the reference's pytree layout, as tensors):
    {"embed": (V, D), "blocks": stacked (L, ...) block params (an MoE
     block's experts under "moe", see :mod:`repro_torch.models.moe`),
     "final_norm": {"scale": (D,)}, "lm_head": (D, V) (absent when the
     embedding is tied), "branches": {"scale": (n_branches, D)},
     "shared_attn": one GQA block (hybrid),
     "dense_blocks": the first ``first_k_dense`` layers, stacked, before
     "blocks" (DeepSeek-V3), "mtp_block": one dense block and "mtp_norm"
     (``use_mtp``)}
Under the non-parametric LayerNorm (OLMo) every norm's params, the
branches' included, are ``{}``.

Training (:func:`forward_train`) is the reference's joint BranchyNet loss:
the main head's cross-entropy plus ``branch_loss_weight`` times each
branch's (plus ``router_aux_weight`` times the summed router aux loss of
the MoE blocks), each head's loss recomputed in the backward pass
(``torch.utils.checkpoint``) so that no logits are saved.
Caches (full-batch resident, updated in place):
    {"length": () int32,
     "blocks": {"self": {"k", "v": (L, B, C, Kh, D), "pos": (L, B, C) int32,
                         "length": (L,) int32}}             (dense)
               {"self": {"conv": (L, B, W-1, conv_dim) f32,
                         "ssm": (L, B, H, P, N) f32, "length": (L,)}}  (ssm)
     "shared_attn": {"self": KV ring with a leading (n_sites,) axis} (hybrid),
     "dense_blocks", "blocks": {"self": {"ckv": (L, B, C, kv_rank),
                         "k_rope": (L, B, C, rope_dim), "pos", "length"}}
                                                            (MLA),
     "cross_kv": a tuple (k, v), each (L, B, S_enc, Kh, D)  (audio)}
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.calibration import normalized_entropy
from repro_torch.kernels.ops import resolve_device, resolve_use_kernels
from repro_torch.models.attention import PaddedPrompt
from repro_torch.models.layers import (
    dense,
    embed,
    norm_apply,
    norm_init,
    sinusoidal_embed,
    sinusoidal_positions,
)
from repro_torch.models.transformer import (
    BlockKind,
    block_apply,
    cast_tree,
    init_block_cache,
    layer_slice,
    recomputed,
    run_stack,
    stack_init,
    unstack,
)
from repro_torch.sharding.ctx import constrain, is_dtensor, local, local_rows, split_dim

__all__ = [
    "branch_logits_per_head",
    "branch_logits_stacked",
    "compute_cross_kv",
    "compute_dtype",
    "compute_params",
    "decode_step",
    "embed_decode",
    "encode_audio",
    "forward_train",
    "hybrid_sites",
    "init_caches",
    "init_params",
    "prefill",
    "run_trunk",
    "softmax_xent",
    "trunk_layout",
]

_MATMUL_LEAVES = frozenset(
    {"embed", "lm_head", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
     "w_z", "w_xbc", "w_dt", "out_proj", "router",
     "wq_a", "wq_b", "wkv_a", "wk_b", "wv_b"}
)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def trunk_layout(cfg: ModelConfig) -> list[tuple[str, BlockKind, int]]:
    """Ordered stacks composing the trunk: (param key, kind, n_layers)."""
    if cfg.arch_type in ("dense", "vlm"):
        return [("blocks", BlockKind("gqa", "dense"), cfg.num_layers)]
    if cfg.arch_type == "moe":
        mixer = "mla" if cfg.use_mla else "gqa"
        out = []
        if cfg.first_k_dense:  # DeepSeek-V3: the first layers stay dense
            out.append(("dense_blocks", BlockKind(mixer, "dense"), cfg.first_k_dense))
        out.append(("blocks", BlockKind(mixer, "moe"),
                    cfg.num_layers - cfg.first_k_dense))
        return out
    if cfg.arch_type in ("ssm", "hybrid"):
        return [("blocks", BlockKind("mamba", "none"), cfg.num_layers)]
    if cfg.arch_type == "audio":
        # The decoder trunk only; the encoder is a stack of its own.
        return [("blocks", BlockKind("gqa", "dense", cross_attention=True,
                                     use_rope=False), cfg.num_layers)]
    raise ValueError(cfg.arch_type)


def hybrid_sites(cfg: ModelConfig) -> tuple[int, ...]:
    """Trunk layers after which the shared attention block runs (Zamba2)."""
    if cfg.arch_type != "hybrid" or not cfg.attn_every:
        return ()
    return tuple(range(cfg.attn_every, cfg.num_layers + 1, cfg.attn_every))


_SHARED_ATTN_KIND = BlockKind("gqa", "dense")
_ENC_KIND = BlockKind("gqa", "dense", causal=False, use_rope=False)


def _mtp_kind(cfg: ModelConfig) -> BlockKind:
    """The multi-token-prediction block: one dense block of the trunk's
    attention kind."""
    return BlockKind("mla" if cfg.use_mla else "gqa", "dense")


def _total_layers(cfg: ModelConfig) -> int:
    return sum(n for _, _, n in trunk_layout(cfg))


# ---------------------------------------------------------------- init
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random params drawn from ``generator`` (which must live on
    ``device``, by default the current CUDA device): fan-in scaled
    truncated normals for the projections (the Mamba2 mixer's own
    distributions in :func:`repro_torch.models.mamba.mamba_init`),
    N(0, 0.02^2) for the embedding and LM head, unit norm scales; fp32,
    or bf16 under ``param_dtype="bfloat16"``.

    Under bf16 every leaf lives in bf16, as the reference casts its tree.
    Each leaf is cast as soon as it is drawn (the MoE experts one layer at
    a time), so the fp32 transient is one leaf, not a whole stack: the
    draws, their order and so the values are those of an fp32 draw cast
    afterwards."""
    layout = trunk_layout(cfg)
    device = resolve_device(device)
    d, v = cfg.d_model, cfg.padded_vocab_size
    pd = torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32

    def normal(*shape, std):
        return torch.randn(shape, generator=generator, device=device).mul_(std).to(pd)

    def norm(lead=()):
        return cast_tree(norm_init(cfg.norm_type, d, device, lead), pd)

    params = {"embed": normal(v, d, std=0.02)}
    for name, kind, n in layout:
        params[name] = stack_init(cfg, kind, n, generator, device, pd)
    if cfg.arch_type == "hybrid":
        params["shared_attn"] = layer_slice(
            stack_init(cfg, _SHARED_ATTN_KIND, 1, generator, device, pd), 0)
    params["final_norm"] = norm()
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(d, v, std=0.02)
    if cfg.branch_layers:
        params["branches"] = norm((len(cfg.branch_layers),))
    if cfg.arch_type == "audio":
        params["encoder"] = stack_init(cfg, _ENC_KIND, cfg.num_encoder_layers,
                                       generator, device, pd)
        params["enc_norm"] = norm()
    if cfg.use_mtp:
        params["mtp_block"] = layer_slice(
            stack_init(cfg, _mtp_kind(cfg), 1, generator, device, pd), 0)
        params["mtp_norm"] = norm()
    return params


def compute_params(params: dict, dtype=torch.bfloat16) -> dict:
    """A params tree whose matmul weights are ``dtype`` copies (norm scales
    stay fp32).  ``dense`` / ``embed`` cast fp32 weights to bf16 at every
    call, as the reference does; holding the copies once gives bitwise the
    same results without re-casting ~15 GB of weights every decode step."""
    def walk(tree):
        return {
            k: walk(v) if isinstance(v, dict)
            else (v.to(dtype) if k in _MATMUL_LEAVES else v)
            for k, v in tree.items()
        }
    return walk(params)


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, dtype=None,
                device=None) -> dict:
    """Empty full-batch caches on ``device`` (default: the current CUDA
    device)."""
    dtype = dtype or compute_dtype(cfg)
    device = resolve_device(device)
    cap = min(seq_len, cfg.sliding_window) if cfg.sliding_window else seq_len

    def stacked(tree, n):
        return {k: stacked(v, n) if isinstance(v, dict)
                else v.expand(n, *v.shape).contiguous() for k, v in tree.items()}

    caches: dict = {"length": torch.zeros((), dtype=torch.int32, device=device)}
    for name, kind, n in trunk_layout(cfg):
        caches[name] = stacked(
            init_block_cache(batch, cap, cfg, kind, dtype, device), n)
    sites = hybrid_sites(cfg)
    if sites:
        caches["shared_attn"] = stacked(init_block_cache(
            batch, cap, cfg, _SHARED_ATTN_KIND, dtype, device), len(sites))
    if cfg.arch_type == "audio":
        shape = (cfg.num_layers, batch, cfg.encoder_seq_len, cfg.num_kv_heads,
                 cfg.head_dim)
        caches["cross_kv"] = (torch.zeros(shape, dtype=dtype, device=device),
                              torch.zeros(shape, dtype=dtype, device=device))
    return caches


# ---------------------------------------------------------------- trunk
def run_trunk(
    params: dict,
    h: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,
    caches: dict | None = None,
    *,
    layer_range: tuple[int, int] | None = None,  # absolute, 0-based [lo, hi)
    collect: tuple[int, ...] = (),  # 1-based "after layer i" points
    moe_dispatch: str = "einsum",
    rows=None,
    use_kernels: bool = False,
    remat: bool = False,
    cross_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, dict | None, torch.Tensor | float,
           dict[int, torch.Tensor]]:
    """Run trunk layers [lo, hi), segmenting at the ``collect`` layers,
    (hybrid) the shared-attention sites and the ends of the trunk's stacks
    (DeepSeek-V3: the dense stack, then the MoE stack; layers are numbered
    across them).  Returns (h, caches, aux, {layer:
    hidden}); caches are updated in place; aux is the summed router aux
    loss of the MoE blocks run (0.0 when none ran).  The shared block runs with the
    layer it follows, so a cut after site s keeps s on the lower tier.
    ``rows``: h is a sub-batch whose stateful reads and writes go to those
    rows of the full-batch caches (decode: a device tensor with
    out-of-bounds sentinels; prefill: a host-side plan, or a
    :class:`~repro_torch.models.attention.PaddedPrompt`).  ``remat``: each
    trunk layer is recomputed in the backward pass (the shared block is
    not, as in the reference).  ``moe_dispatch``: the MoE blocks' dispatch
    mode (:func:`repro_torch.models.moe.moe_apply`).  ``cross_kv``: the
    decoder layers' stacked encoder (K, V) (Whisper); by default the
    caches' ``cross_kv``, when they hold one."""
    stacks, acc = [], 0  # (param key, kind, first layer, end)
    for name, kind, n in trunk_layout(cfg):
        stacks.append((name, kind, acc, acc + n))
        acc += n
    lo, hi = layer_range or (0, acc)
    sites = hybrid_sites(cfg)
    # A stack's end is a stop too, so no segment crosses two stacks.
    stops = sorted({hi, *(c for c in (*collect, *sites, *(e for *_, e in stacks))
                          if lo < c < hi)})
    # Each stack's layers in [lo, hi), unbound once, keyed relative to it.
    layers = {name: unstack(params[name], max(lo, s_lo) - s_lo, min(hi, s_hi) - s_lo)
              for name, _, s_lo, s_hi in stacks if s_lo < hi and lo < s_hi}
    if cross_kv is None and caches is not None:
        cross_kv = caches.get("cross_kv")
    cross = None
    if cross_kv is not None:  # one decoder stack: its layers are the trunk's
        cross = dict(zip(range(lo, hi), zip(*(t[lo:hi].unbind() for t in cross_kv))))
    collected: dict[int, torch.Tensor] = {}
    aux = 0.0
    start = lo
    for stop in stops:
        if start < stop:
            name, kind, s_lo, _ = next(st for st in stacks if st[2] <= start < st[3])
            h, a = run_stack(
                layers[name], h, cfg, kind, positions,
                caches[name] if caches is not None else None,
                lo=start - s_lo, hi=stop - s_lo, cross=cross,
                moe_dispatch=moe_dispatch, rows=rows, use_kernels=use_kernels,
                remat=remat,
            )
            h = constrain(h, "b..")
            aux = aux + a
        if stop in sites:
            site_cache = (layer_slice(caches["shared_attn"], sites.index(stop))
                          if caches is not None else None)
            h, _ = block_apply(params["shared_attn"], h, cfg, _SHARED_ATTN_KIND,
                               positions, site_cache, rows=rows,
                               use_kernels=use_kernels)
        if stop in collect:
            collected[stop] = h
        start = stop
    return h, caches, aux, collected


# ---------------------------------------------------------------- heads
def _unembed(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = dense(w, h, h.dtype)
    if cfg.padded_vocab_size != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab_size, device=h.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def branch_logits_stacked(
    params: dict,
    collected: dict[int, torch.Tensor],
    cfg: ModelConfig,
    layers: Sequence[int] | None = None,
) -> tuple[tuple[int, ...], torch.Tensor | None]:
    """Batched tied exit heads: one stacked norm + one unembedding matmul
    for every requested branch present in ``collected``.  Returns
    ``(layers, logits (K, B, S, V))`` in layer order, ``((), None)`` when
    none is present."""
    want = cfg.branch_layers if layers is None else tuple(layers)
    present = tuple(l for l in want if l in collected)
    if not present:
        return (), None
    idx = [cfg.branch_layers.index(l) for l in present]
    hs = torch.stack([collected[l] for l in present])  # (K, B, S, D)
    return present, _unembed(params, _stacked_branch_norm(params, hs, idx, cfg), cfg)


def _stacked_branch_norm(params: dict, hs: torch.Tensor, idx: Sequence[int],
                         cfg: ModelConfig) -> torch.Tensor:
    """Per-branch norm over stacked hiddens ``hs`` (K, ..., D); ``idx[k]``
    selects head k's row of the stacked branch params.  A parameter-free
    norm gets ``{}``."""
    if cfg.norm_type != "rmsnorm":
        return norm_apply(cfg.norm_type, {}, hs)
    # Python-int row views: no index tensor has to cross to the device.
    scale = torch.stack([params["branches"]["scale"][i] for i in idx])
    bcast = scale.reshape(scale.shape[0], *([1] * (hs.dim() - 2)), -1)
    return norm_apply(cfg.norm_type, {"scale": bcast}, hs)


def branch_logits_per_head(
    params: dict, collected: dict[int, torch.Tensor], cfg: ModelConfig
) -> dict[int, torch.Tensor]:
    """Sequential reference heads: one norm + one unembedding per branch."""
    out = {}
    for j, layer in enumerate(cfg.branch_layers):
        if layer in collected:
            hb = _stacked_branch_norm(params, collected[layer], [j], cfg)
            out[layer] = _unembed(params, hb, cfg)
    return out


# ---------------------------------------------------------------- serving
def prefill(
    params: dict,
    tokens: torch.Tensor,  # (B, S) int
    cfg: ModelConfig,
    caches: dict,
    *,
    patch_embeds: torch.Tensor | None = None,  # (B, num_patches, d): vlm
    frame_embeds: torch.Tensor | None = None,  # (B, S_enc, d): audio
    moe_dispatch: str = "einsum",
    rows=None,
    use_kernels: bool = False,
) -> tuple[torch.Tensor, dict]:
    """Process whole prompts; returns (last-position logits (B, 1, V),
    caches).  A ``vlm`` prompt is its ``patch_embeds`` followed by its
    tokens (the reference's ``inputs["patch_embeds"]``), so its cache
    holds ``num_patches + S`` positions.  An ``audio`` prompt's
    ``frame_embeds`` run through the encoder, and every decoder layer's
    cross K/V is written into ``caches["cross_kv"]`` in place.  ``rows``
    (continuous-batching admission, a host-side plan): prompt row i
    prefills cache row ``rows[i]`` in place, ending exactly as a fresh
    solo prefill; sentinel rows (>= B) drop their writes and the step
    counter is untouched (not for ``audio``, as in the reference).  A
    :class:`~repro_torch.models.attention.PaddedPrompt` plan is the same
    for one prompt padded on the right, with its row and true length L on
    the device (a graph-capturable admission): its cache row ends as the
    unpadded prompt's would, and the logits are those at position L - 1.
    Pad positions come after every real one, so no real position reads
    them; a routed-expert trunk would let them take expert capacity, and
    raises.  ``use_kernels``: the admission scan of a Mamba2 layer runs in
    the Hopper ``ssd_scan`` kernel."""
    if rows is not None and cfg.arch_type == "audio":
        raise NotImplementedError(
            "row-targeted prefill does not cover encoder cross-KV caches")
    padded = isinstance(rows, PaddedPrompt)
    if padded and (patch_embeds is not None
                   or any(kind.mlp == "moe" for _, kind, _ in trunk_layout(cfg))):
        raise NotImplementedError(
            "a padded prompt covers text trunks without routed experts")
    inputs = {"tokens": tokens}
    if patch_embeds is not None:
        inputs["patch_embeds"] = patch_embeds
    h, positions = _embed_inputs(params, inputs, cfg)
    h = constrain(h, "b..")
    if cfg.arch_type == "audio":
        if frame_embeds is None:
            raise ValueError("an audio prompt needs its frame_embeds")
        enc_out = encode_audio(params, frame_embeds, cfg)
        for buf, t in zip(caches["cross_kv"], compute_cross_kv(params, enc_out, cfg)):
            buf.copy_(t)
    h2, caches, _, _ = run_trunk(params, h, cfg, positions, caches,
                                 moe_dispatch=moe_dispatch, rows=rows,
                                 use_kernels=use_kernels)
    if rows is None:
        local(caches["length"]).fill_(h.shape[1])  # each rank's copy, when sharded
    if padded:
        last = norm_apply(cfg.norm_type, params["final_norm"],
                          h2.index_select(1, rows.length - 1))
        return _unembed(params, last, cfg), caches
    hf = norm_apply(cfg.norm_type, params["final_norm"], h2)
    return constrain(_unembed(params, hf[:, -1:], cfg), "b.v"), caches


def embed_decode(params: dict, token: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Embed one decode-step token (B, 1) — the entry of the tier holding
    trunk layer 1.  ``positions`` (the shared (1,) step position, or (B, 1)
    per sequence) is read only by the ``audio`` trunk, which adds the
    sinusoidal embedding at it; a RoPE trunk rotates in attention."""
    dtype = compute_dtype(cfg)
    h = embed(params["embed"], token, dtype)
    if cfg.arch_type == "audio":
        emb = sinusoidal_embed(positions, cfg.d_model).to(dtype)
        h = h + (emb if positions.dim() == 2 else emb[None])
    return h


def decode_step(
    params: dict,
    token: torch.Tensor,  # (B, 1) int
    pos: torch.Tensor,  # () absolute position of this token
    caches: dict,
    cfg: ModelConfig,
    *,
    layer_range: tuple[int, int] | None = None,
    with_branches: bool = True,
    moe_dispatch: str = "einsum",
    use_kernels: bool | None = None,  # None = cfg.use_kernels, then auto
) -> dict[str, Any]:
    """One lock-step decode step.  Returns logits (or the hidden stream for
    a partial layer range), per-branch logits / entropies / exit masks, and
    the caches (updated in place)."""
    kernels = resolve_use_kernels(
        cfg.use_kernels if use_kernels is None else use_kernels, token.device)
    positions = torch.as_tensor(pos, device=token.device).to(torch.int32).reshape(1)
    h = embed_decode(params, token, positions, cfg)
    collect = cfg.branch_layers if with_branches else ()
    h2, caches, _, collected = run_trunk(
        params, h, cfg, positions, caches, layer_range=layer_range,
        collect=collect, moe_dispatch=moe_dispatch, use_kernels=kernels,
    )
    out: dict[str, Any] = {}
    if layer_range is None or layer_range[1] == _total_layers(cfg):
        hf = norm_apply(cfg.norm_type, params["final_norm"], h2)
        out["logits"] = constrain(_unembed(params, hf, cfg), "b.v")[:, 0]
    else:
        out["hidden"] = h2
    if with_branches:
        layers, stk = branch_logits_stacked(params, collected, cfg)
        out["branch_logits"] = {l: stk[k, :, 0] for k, l in enumerate(layers)}
        out["branch_entropy"] = {
            l: normalized_entropy(v) for l, v in out["branch_logits"].items()
        }
        out["branch_exit"] = {
            l: e < cfg.exit_threshold for l, e in out["branch_entropy"].items()
        }
    caches["length"] += 1
    out["caches"] = caches
    return out


# ---------------------------------------------------------------- train
def _label_logits(lf: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``lf[..., labels]``.  A vocab-sharded DTensor (a sharded train
    step) picks on each rank's vocab shard, zero where the label lies in
    another, and the pick is a partial sum over those ranks: DTensor's own
    rule for the gather (a masked partial) fails to reduce on a batch-
    sharded operand."""
    if not is_dtensor(lf):
        return lf.gather(-1, labels[..., None].long())[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, nd = lf.device_mesh, lf.dim()
    pl = list(lf.placements)
    vocab = [isinstance(p, Shard) and p.dim % nd == nd - 1 for p in pl]
    lab_pl = [Replicate() if v or not isinstance(p, Shard) else p
              for v, p in zip(vocab, pl)]
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    lab = labels.redistribute(mesh, lab_pl).to_local().long()
    loc, off = local_rows(lf, dim=-1)
    idx = lab - off
    inside = (idx >= 0) & (idx < loc.shape[-1])
    picked = loc.gather(-1, idx.clamp(0, loc.shape[-1] - 1)[..., None])[..., 0]
    picked = torch.where(inside, picked, 0.0)
    return DTensor.from_local(picked, mesh,
                              [Partial() if v else p for v, p in zip(vocab, lab_pl)],
                              run_check=False)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean masked token cross-entropy, fp32 reductions."""
    lf = logits.float()
    nll = torch.logsumexp(lf, dim=-1) - _label_logits(lf, labels)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def _embed_inputs(params: dict, inputs: dict,
                  cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """(h (B, S, d), positions (S,)): the token embeddings, after the
    precomputed ``patch_embeds`` (B, num_patches, d) under the vision
    frontend (cast to the compute dtype, as the reference does), plus the
    sinusoidal table on an ``audio`` trunk (Whisper's decoder).  Any other
    frontend embeds the tokens alone, as the reference does."""
    dtype = compute_dtype(cfg)
    h = embed(params["embed"], inputs["tokens"], dtype)
    if cfg.frontend == "vision":
        if "patch_embeds" not in inputs:
            raise ValueError("a vision-frontend prompt needs its patch_embeds")
        h = torch.cat([inputs["patch_embeds"].to(dtype), h], dim=1)
    s = h.shape[1]
    if cfg.arch_type == "audio":
        h = h + sinusoidal_positions(s, cfg.d_model, h.device).to(dtype)[None]
    return h, torch.arange(s, dtype=torch.int32, device=h.device)


def encode_audio(params: dict, frame_embeds: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Whisper's encoder over (stubbed) conv-frontend frame embeddings (B,
    S_enc, d): the sinusoidal table added, the encoder stack (causally
    masked, as the reference's is), then its final norm."""
    dtype = compute_dtype(cfg)
    h = frame_embeds.to(dtype)
    s = h.shape[1]
    h = h + sinusoidal_positions(s, cfg.d_model, h.device).to(dtype)[None]
    pos = torch.arange(s, dtype=torch.int32, device=h.device)
    n = cfg.num_encoder_layers
    h, _ = run_stack(unstack(params["encoder"], 0, n), h, cfg, _ENC_KIND, pos,
                     lo=0, hi=n)
    return norm_apply(cfg.norm_type, params["enc_norm"], h)


def compute_cross_kv(params: dict, enc_out: torch.Tensor,
                     cfg: ModelConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross (K, V) of the encoder's output, each
    stacked (L, B, S_enc, Kh, D)."""
    b, s, _ = enc_out.shape
    shape = (cfg.num_layers, b, s, cfg.num_kv_heads, cfg.head_dim)
    xattn = params["blocks"]["xattn"]
    if is_dtensor(enc_out):
        # A sharded step: one product per layer, each folding the batch
        # first (the stacked product would fold it behind the layers).
        return tuple(torch.stack([
            split_dim(dense(xattn[w][i], enc_out, enc_out.dtype), -1, shape[-2:])
            for i in range(cfg.num_layers)]) for w in ("wk", "wv"))
    x = enc_out.reshape(1, b * s, -1)
    return tuple(dense(xattn[w], x, enc_out.dtype).reshape(shape) for w in ("wk", "wv"))


def forward_train(params: dict, batch: dict, cfg: ModelConfig, *,
                  moe_dispatch: str = "einsum") -> dict[str, Any]:
    """The joint BranchyNet training loss (paper Sec. III, BranchyNet [5]):
    main CE + ``branch_loss_weight`` x sum_k CE_k + ``router_aux_weight``
    x the summed router aux loss of the MoE blocks (zero for a trunk
    without experts), + 0.3 x the multi-token-prediction CE under
    ``use_mtp`` (reported as ``branch_losses["mtp"]``).  ``batch``: ``tokens`` and ``labels`` (B, S),
    optional ``mask``, ``patch_embeds`` under the vision frontend, whose
    positions' logits every head drops, and ``frame_embeds`` for an
    ``audio`` trunk (the encoder runs without remat, as the reference's);
    token t predicts label t + 1.

    Each head's loss runs under ``recomputed``: otherwise the (B, S, V)
    logits of every head would be saved for the backward pass in fp32.
    All K branch heads share one stacked norm and one unembedding (the
    serving runtime prices them the same way); the backward pass's
    recompute materializes all K heads' logits at once."""
    h, positions = _embed_inputs(params, batch, cfg)
    cross = None
    if cfg.arch_type == "audio":
        cross = compute_cross_kv(params, encode_audio(params, batch["frame_embeds"], cfg),
                                 cfg)
    h2, _, aux, collected = run_trunk(params, h, cfg, positions,
                                      collect=cfg.branch_layers,
                                      moe_dispatch=moe_dispatch, remat=cfg.remat,
                                      cross_kv=cross)
    labels = batch["labels"][:, 1:]
    mask = batch.get("mask")
    mask = None if mask is None else mask[:, 1:]
    n_patch = cfg.num_patches if cfg.frontend == "vision" else 0

    def head_loss(h):
        hn = norm_apply(cfg.norm_type, params["final_norm"], h)
        logits = constrain(_unembed(params, hn, cfg), "b.v")[:, n_patch:]
        return softmax_xent(logits[:, :-1], labels, mask)

    main_loss = recomputed(head_loss, h2)
    branch_losses: dict[str, torch.Tensor] = {}
    present = tuple(l for l in cfg.branch_layers if l in collected)
    if present:
        idx = [cfg.branch_layers.index(l) for l in present]

        def branch_loss(hs):
            logits = constrain(_unembed(params, _stacked_branch_norm(params, hs, idx, cfg),
                                        cfg), ".b.v")
            return torch.stack([softmax_xent(lg[:, n_patch:][:, :-1], labels, mask)
                                for lg in logits])

        bl = recomputed(branch_loss, torch.stack([collected[l] for l in present]))
        for k, layer in enumerate(present):
            branch_losses[f"branch_{layer}"] = bl[k]
    aux = torch.as_tensor(aux, dtype=torch.float32, device=h.device)
    loss = main_loss + cfg.branch_loss_weight * sum(branch_losses.values())
    loss = loss + cfg.router_aux_weight * aux
    if cfg.use_mtp:
        # DeepSeek-V3's multi-token prediction, single depth as in the
        # reference: one more dense block on the trunk's output predicts
        # token t + 2.
        labels2 = batch["labels"][:, 2:]
        mask2 = None if batch.get("mask") is None else batch["mask"][:, 2:]

        def mtp_loss_fn(h):
            h_mtp, _ = block_apply(params["mtp_block"], h, cfg, _mtp_kind(cfg),
                                   positions)
            hn = norm_apply(cfg.norm_type, params["mtp_norm"], h_mtp)
            logits = constrain(_unembed(params, hn, cfg), "b.v")[:, n_patch:]
            return softmax_xent(logits[:, :-2], labels2, mask2)

        branch_losses["mtp"] = recomputed(mtp_loss_fn, h2)
        loss = loss + 0.3 * branch_losses["mtp"]
    return {"loss": loss, "main_loss": main_loss, "aux_loss": aux,
            "branch_losses": branch_losses}
