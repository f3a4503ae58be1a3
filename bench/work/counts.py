"""FLOPs and bytes that the served model's work needs, from shapes alone:
the roofline arithmetic of the per-layer metrics.  Counts are of the
model's need, not of what a kernel does: every input byte read once,
every output byte written once, and for decode attention only the valid
K/V slots of the rows that ran the layer.  Weights and K/V are bf16 (2
bytes), SSM state and the SSD step's x and dt fp32 (4 bytes).

``m`` is the configuration file's ``model`` object."""

from __future__ import annotations

BF16, FP32 = 2, 4


def _vocab(m: dict) -> int:
    v = m["vocab_size"]
    return v if v % 256 == 0 or v % 16 == 0 else (v + 255) // 256 * 256


def attn_layers(m: dict, lo: int, hi: int) -> int:
    """Attention layers run by trunk layers [lo, hi) (0-based): every
    layer of a dense trunk, the shared-block sites of a hybrid."""
    if m["arch_type"] == "dense":
        return hi - lo
    every = m.get("attn_every") or 0
    return sum(1 for i in range(lo, hi) if every and (i + 1) % every == 0)


def mamba_layers(m: dict, lo: int, hi: int) -> int:
    return hi - lo if m["arch_type"] == "hybrid" else 0


def attn_decode(m: dict, valid_slots: int, rows: int) -> tuple[float, float]:
    """One layer's single-token attention over ``rows`` rows whose valid
    K/V slots sum to ``valid_slots``: (FLOPs, bytes).  Q·K and P·V are 2
    FLOPs a multiply-add each; Q, the valid K and V, and the output are
    read or written once."""
    h, kh, d = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    flops = 4.0 * h * d * valid_slots
    nbytes = BF16 * (2.0 * kh * d * valid_slots + 2.0 * h * d * rows)
    return flops, nbytes


def _ssm(m: dict) -> tuple[int, int, int, int]:
    inner = m["ssm_expand"] * m["d_model"]
    h = m["ssm_num_heads"] or inner // m["ssm_head_dim"]
    return h, inner // h, m["ssm_state_dim"], m["ssm_num_groups"]


def ssd_update(m: dict, rows: int) -> tuple[float, float]:
    """One layer's SSD decode step over ``rows`` rows: the fp32 state read
    and written once, x (fp32), dt (fp32), B and C (bf16) read once, y
    (fp32) written once.  5 FLOPs a state element: the decay, the outer
    product's multiply-add, and y's multiply-add."""
    h, p, n, g = _ssm(m)
    state = h * p * n
    flops = 5.0 * state * rows
    nbytes = rows * (2.0 * FP32 * state + FP32 * (2 * h * p + h) + BF16 * 2 * g * n)
    return flops, nbytes


def cache_bytes(m: dict, split: int, edge_slots: int, cloud_slots: int, rows: int) -> float:
    """Bytes of the serving caches that hold data: the K/V of ``edge_slots``
    positions in each attention layer before ``split`` and of
    ``cloud_slots`` positions in each after it, and the fp32 SSM state of
    ``rows`` rows in each Mamba2 layer (the conv windows left out)."""
    kv = BF16 * 2 * m["num_kv_heads"] * m["head_dim"]
    n = m["num_layers"]
    out = kv * (attn_layers(m, 0, split) * edge_slots + attn_layers(m, split, n) * cloud_slots)
    if mamba_layers(m, 0, n):
        h, p, s, _g = _ssm(m)
        out += mamba_layers(m, 0, n) * FP32 * h * p * s * rows
    return float(out)


def layer_weight_params(m: dict, lo: int, hi: int) -> int:
    """Matmul weights of trunk layers [lo, hi), the shared block counted
    at each site it runs."""
    d, ff = m["d_model"], m["d_ff"]
    q, kv = m["num_heads"] * m["head_dim"], m["num_kv_heads"] * m["head_dim"]
    attn_mlp = 2 * d * q + 2 * d * kv + 3 * d * ff
    if m["arch_type"] == "dense":
        return (hi - lo) * attn_mlp
    h, p, n, g = _ssm(m)
    inner = h * p
    mamba = d * (2 * inner + 2 * g * n + h) + inner * d
    return (hi - lo) * mamba + attn_layers(m, lo, hi) * attn_mlp


def segment(m: dict, lo: int, hi: int, rows: int, valid_slots: int,
            heads: int) -> tuple[float, float]:
    """One decode step of trunk layers [lo, hi) over ``rows`` rows, with
    ``heads`` heads (side branches or the final head) on every row: the
    weights read once, the K/V of ``valid_slots`` slots read in each
    attention layer and one slot a row written, the SSM state read and
    written in each Mamba2 layer.  (FLOPs, bytes)."""
    d, v = m["d_model"], _vocab(m)
    w = layer_weight_params(m, lo, hi)
    flops = 2.0 * w * rows + 2.0 * heads * d * v * rows
    nbytes = BF16 * (w + (d * v if heads else 0) + d * rows)
    n_attn = attn_layers(m, lo, hi)
    af, ab = attn_decode(m, valid_slots, rows)
    kv_write = BF16 * 2 * m["num_kv_heads"] * m["head_dim"] * rows
    flops += n_attn * af
    nbytes += n_attn * (ab + kv_write)
    n_mamba = mamba_layers(m, lo, hi)
    if n_mamba:
        sf, sb = ssd_update(m, rows)
        flops += n_mamba * sf
        nbytes += n_mamba * sb
    return flops, nbytes


def prefill(m: dict, prompt_len: int) -> tuple[float, float]:
    """Admitting one prompt of ``prompt_len`` tokens through every layer:
    the weight products of every token, causal attention (half of the S x S
    scores), the final head on the last token; the weights read once, the
    prompt's K/V written once in each attention layer, the final SSM state
    written once in each Mamba2 layer.  (FLOPs, bytes)."""
    L, d, v, s = m["num_layers"], m["d_model"], _vocab(m), prompt_len
    w = layer_weight_params(m, 0, L)
    h, hd, kh = m["num_heads"], m["head_dim"], m["num_kv_heads"]
    n_attn = attn_layers(m, 0, L)
    flops = 2.0 * w * s + 2.0 * d * v + n_attn * 2.0 * h * hd * s * (s + 1)
    nbytes = BF16 * (w + d * v + d * s) + n_attn * BF16 * 2 * kh * hd * s
    n_mamba = mamba_layers(m, 0, L)
    if n_mamba:
        sh, p, n, _g = _ssm(m)
        flops += n_mamba * 5.0 * sh * p * n * s  # the recurrence's own work
        nbytes += n_mamba * FP32 * sh * p * n
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, peaks: dict) -> float:
    """The roofline's least time: the larger of FLOPs over the bf16 peak
    and bytes over the memory peak."""
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])
