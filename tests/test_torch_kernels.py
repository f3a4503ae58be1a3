"""The port's decode-path kernels against the reference package on the CPU.

The port's plain versions (``repro_torch.kernels.ref``, which its dispatch
wrappers run for CPU tensors) are held against the reference's jnp oracles
(``repro.kernels.ref``) and its Pallas kernels in interpret mode, on the
same inputs made with numpy.  The Hopper kernels themselves run only on
the card (``chip_smoke.py`` holds them against these plain versions);
the flash_decode and exit kernels' split-and-merge algorithms are emulated
here with their launchers' own split plans.

Tolerances:
  * entropy |dH| <= 1e-5: both sides are fp32 log-softmax sums (or the
    Pallas online form); they differ by exp/log rounding only;
  * tokens exact: argmax over identical bf16 values, first index on ties;
  * flags exact wherever |H - thr| >= 1e-5;
  * attention: fp32 inputs 1e-5; bf16 outputs within one bf16 ulp
    (at most 2^-7 relative) plus 1e-5, since each side rounds its fp32
    result once.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.entropy_exit import (
    entropy_exit_argmax_heads_pallas,
    entropy_exit_argmax_pallas,
)
from repro.kernels.flash_decode import flash_decode_pallas
from repro_torch.kernels import build, ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.entropy_exit import SPLITS
from repro_torch.kernels.entropy_exit import split_plan as exit_split_plan
from repro_torch.kernels.flash_decode import SPLIT, split_plan

BF16_ULP = 2.0 ** -7  # one bf16 ulp is at most 2^-7 of the value


def _bf16(x: np.ndarray):
    """The same bf16 values on both sides (both round fp32 to nearest even)."""
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()


def _logits(k, b, v, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((k, b, v)) * 4).astype(np.float32)
    x[0, 0, -24:] = -1e30  # vocab-padding lanes inside the width
    x[-1, min(1, b - 1), [3, v - 5]] = 40.0  # tie across the row
    x[0, b - 1, [7, 9]] = 40.0  # tie inside one tile
    return x


def _assert_decision(h, flag, tok, hr, fr, tr, thr):
    h, hr = np.asarray(h, np.float32), np.asarray(hr, np.float32)
    np.testing.assert_allclose(h, hr, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(tok), np.asarray(tr))
    thr = np.broadcast_to(np.asarray(thr, np.float32).reshape(-1, 1), hr.shape) \
        if hr.ndim == 2 else np.float32(thr)
    clear = np.abs(hr - thr) >= 1e-5
    np.testing.assert_array_equal(np.asarray(flag)[clear], np.asarray(fr)[clear])


class TestEntropyExitHeads:
    @pytest.mark.parametrize("k,b,v", [(2, 8, 1000), (3, 4, 2048), (1, 5, 5003)])
    @pytest.mark.parametrize("per_head", [False, True])
    def test_plain_matches_reference(self, k, b, v, per_head):
        x = _logits(k, b, v, seed=k * v + b)
        jx, tx = _bf16(x)
        h0 = np.asarray(jref.entropy_exit_argmax_heads_ref(jx, 0.5)[0])
        thr = np.median(h0, axis=1) if per_head else float(np.median(h0))
        jth = jnp.asarray(thr, jnp.float32)
        tth = torch.as_tensor(thr, dtype=torch.float32)
        out = tref.entropy_exit_argmax_heads_ref(tx, tth)
        ref = jref.entropy_exit_argmax_heads_ref(jx, jth)
        _assert_decision(*[o.numpy() for o in out], *ref, thr)
        pallas = entropy_exit_argmax_heads_pallas(jx, jth, interpret=True)
        _assert_decision(*[o.numpy() for o in out], *pallas, thr)

    def test_ties_resolve_to_first_index(self):
        x = np.zeros((2, 3, 4096), np.float32)
        x[:, :, 100] = x[:, :, 3000] = 5.0
        x[1, 2, 7] = x[1, 2, 9] = 9.0
        _, _, tok = tref.entropy_exit_argmax_heads_ref(torch.from_numpy(x), 0.5)
        np.testing.assert_array_equal(tok.numpy(), [[100] * 3, [100, 100, 7]])

    def test_wrapper_runs_plain_version_on_cpu(self):
        x = torch.from_numpy(_logits(2, 4, 640, seed=1)).bfloat16()
        ops.reset_launches()
        got = ops.entropy_exit_argmax_heads(x, 0.7)
        want = tref.entropy_exit_argmax_heads_ref(x, 0.7)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert ops.launches["entropy_exit_argmax_heads"] == 0


class TestEntropyExitSingleHead:
    @pytest.mark.parametrize("b,v", [(1, 128), (8, 2048), (3, 5003)])
    def test_plain_matches_reference(self, b, v):
        x = _logits(1, b, v, seed=b + v)[0]
        jx, tx = _bf16(x)
        thr = float(np.median(np.asarray(jref.entropy_exit_ref(jx, 0.5)[0])))
        out = [o.numpy() for o in tref.entropy_exit_argmax_ref(tx, thr)]
        _assert_decision(*out, *jref.entropy_exit_argmax_ref(jx, thr), thr)
        _assert_decision(*out, *entropy_exit_argmax_pallas(jx, thr, interpret=True), thr)

    def test_single_head_is_heads_slice(self):
        x = torch.from_numpy(_logits(3, 4, 999, seed=5)).bfloat16()
        th = torch.tensor([0.9, 0.95, 0.99])
        heads = ops.entropy_exit_argmax_heads(x, th)
        for k in range(3):
            one = ops.entropy_exit_argmax(x[k], float(th[k]))
            for a, b in zip(one, heads):
                assert torch.equal(a, b[k])


# ------------------------------------------- the exit kernel's split plan
def _butterfly(vals):
    """The kernel's xor-shuffle sum over the SPLITS lanes (offsets 4, 2, 1),
    lane 0's result."""
    for o in (SPLITS // 2, SPLITS // 4, 1):
        vals = [vals[i] + vals[i ^ o] for i in range(SPLITS)]
    return vals[0]


def _exit_split_merge(logits, thresholds):
    """Test-side emulation of the Hopper exit kernel's algorithm, in fp32:
    each row's V in the launcher's splits (a function of V alone), a
    partial (max m, sum e^(l-m), sum l e^(l-m), first argmax) per split, an
    empty split contributing (-inf, 0, 0) and no index, and the partials
    merged as the cluster's rank 0 merges them (the max, one rescale per
    partial, the sums by the xor butterfly, the argmax by (value, index)).
    Exponentials and the log are taken in float64 and rounded to fp32 (as
    the card's accurate expf / logf come out): a process's first float32
    ``torch.exp`` on a CPU can be ~1.5e-4 off (``normalized_entropy``)."""
    lf = logits.float()
    k, b, v = lf.shape
    split, splits = exit_split_plan(v)
    parts = []
    for r in range(splits):
        lo, hi = min(r * split, v), min((r + 1) * split, v)
        if hi == lo:
            inf = torch.full((k, b), -math.inf)
            parts.append((inf, torch.zeros(k, b), torch.zeros(k, b), inf,
                          torch.full((k, b), 2 ** 31 - 1)))
            continue
        x = lf[..., lo:hi]
        m = x.amax(-1)
        e = torch.exp((x - m[..., None]).double()).float()
        bv, bi = x.max(-1)  # first index of the max
        parts.append((m, e.sum(-1), (x * e).sum(-1), bv, bi + lo))
    mm = torch.stack([p[0] for p in parts]).amax(0)
    w = [torch.where(p[0] == -math.inf, 0.0, torch.exp((p[0] - mm).double()).float())
         for p in parts]
    s = _butterfly([p[1] * wi for p, wi in zip(parts, w)])
    u = _butterfly([p[2] * wi for p, wi in zip(parts, w)])
    bv, bi = parts[0][3], parts[0][4]
    for p in parts[1:]:
        take = (p[3] > bv) | ((p[3] == bv) & (p[4] < bi))
        bv, bi = torch.where(take, p[3], bv), torch.where(take, p[4], bi)
    h = (mm + torch.log(s.double()).float() - u / s) / math.log(v)
    th = torch.as_tensor(thresholds, dtype=torch.float32).reshape(-1).expand(k)
    return h, h < th[:, None], bi.to(torch.int32)


def _exit_case(kind):
    """(K, B, V) fp32 logits (bf16-exact) of one emulation case."""
    if kind.startswith("kbv"):
        k, b, v = map(int, kind[3:].split("-"))
        return _logits(k, b, v, seed=k * v + b)
    rng = np.random.default_rng(len(kind))
    k, b, v = {"split_tie": (2, 4, 2048), "pad_splits": (2, 4, 8192),
               "v5003": (1, 3, 5003), "v40": (2, 3, 40)}[kind]
    x = (rng.standard_normal((k, b, v)) * 4).astype(np.float32)
    split, _ = exit_split_plan(v)
    if kind == "split_tie":  # ties on both sides of a split boundary
        x[0, 0, [split - 1, split]] = 40.0
        x[1, 2, [3 * split + 5, 5 * split + 2]] = 40.0
    if kind == "pad_splits":  # the last two splits all pad lanes
        x[..., -2 * split:] = -1e30
    if kind == "v40":  # splits 5..7 empty; a tie inside one split
        x[1, 1, [9, 12]] = 40.0
    return x


EXIT_KINDS = ["kbv2-8-1000", "kbv3-4-2048", "kbv1-5-5003", "split_tie",
              "pad_splits", "v5003", "v40"]


class TestEntropyExitSplit:
    """The exit kernel's split-and-merge algorithm, emulated with the
    launcher's own split plan, against the reference oracle and the Pallas
    kernel in interpret mode (the kernel itself runs only on the card)."""

    def test_plan_depends_on_v_only(self):
        assert exit_split_plan(32064) == (4008, SPLITS)
        assert exit_split_plan(5003) == (632, SPLITS)
        assert exit_split_plan(40) == (8, SPLITS)  # splits 5..7 empty
        assert exit_split_plan(1) == (8, SPLITS)
        for v in (40, 999, 5003, 32000, 32064, 50432):
            split, splits = exit_split_plan(v)
            # whole 16-byte groups, covering V, the smallest such split
            assert split % 8 == 0 and split * splits >= v
            assert (split - 8) * splits < v

    @pytest.mark.parametrize("kind", EXIT_KINDS)
    def test_emulation_matches_reference_and_pallas(self, kind):
        x = _exit_case(kind)
        jx, tx = _bf16(x)
        h0 = np.asarray(jref.entropy_exit_argmax_heads_ref(jx, 0.5)[0])
        thr = np.median(h0, axis=1).astype(np.float32)
        got = [o.numpy() for o in _exit_split_merge(tx, torch.from_numpy(thr))]
        jth = jnp.asarray(thr)
        _assert_decision(*got, *jref.entropy_exit_argmax_heads_ref(jx, jth), thr)
        _assert_decision(*got, *entropy_exit_argmax_heads_pallas(jx, jth, interpret=True),
                         thr)

    @pytest.mark.parametrize("v", [1, 7, 40, 64, 1000, 5003, 32064, 50432])
    def test_kernel_indexing_covers_each_element_once(self, v):
        """The kernel's index arithmetic with the plan's split: each split's
        whole 16-byte groups (from lo / 8 on) and the row's last V % 8
        elements, read once by the split ending at V, cover [0, V) once."""
        split, splits = exit_split_plan(v)
        seen = np.zeros(v, np.int64)
        for rank in range(splits):
            lo = min(rank * split, v)
            hi = min(lo + split, v)
            g_lo = lo // 8
            g_hi = g_lo + (hi - lo) // 8
            assert g_lo * 8 == lo or lo == hi  # on a group, or empty
            for g in range(g_lo, g_hi):
                seen[8 * g:8 * g + 8] += 1
            tail = (hi - lo) % 8
            assert tail == 0 or hi == v  # only the split ending at V
            seen[hi - tail:hi] += 1
        assert (seen == 1).all()


def _attn_case(b, bc, c, kh, g, d, seed, *, sentinel=False, shared_qpos=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kh * g, d)).astype(np.float32)
    k = rng.standard_normal((bc, c, kh, d)).astype(np.float32)
    v = rng.standard_normal((bc, c, kh, d)).astype(np.float32)
    k_pos = np.tile(np.arange(c, dtype=np.int32), (bc, 1))
    k_pos[rng.random((bc, c)) < 0.15] = -1  # holes
    q_pos = (np.int32(c - 3) if shared_qpos
             else rng.integers(c // 2, c, b).astype(np.int32))
    rows = rng.permutation(bc)[:b].astype(np.int32)
    if sentinel:
        rows[-1] = bc  # the compacted runtime's out-of-bounds sentinel
    return q, k, v, k_pos, q_pos, rows


ATTN_CASES = [
    # b, bc, c, kh, g, d, window, shared q_pos
    (4, 4, 64, 2, 1, 64, 0, False),
    (3, 6, 96, 4, 1, 96, 0, False),  # compacted rows, D = 96
    (2, 5, 128, 2, 2, 64, 0, False),  # G = 2
    (4, 4, 200, 2, 2, 32, 50, False),  # G = 2 with a sliding window
    (4, 8, 64, 4, 1, 64, 0, True),  # shared scalar q_pos
]


class TestFlashDecode:
    @pytest.mark.parametrize("b,bc,c,kh,g,d,window,shared", ATTN_CASES)
    def test_plain_matches_reference_fp32(self, b, bc, c, kh, g, d, window, shared):
        q, k, v, kp, qp, rows = _attn_case(b, bc, c, kh, g, d, c + d,
                                           shared_qpos=shared)
        want = jref.flash_decode_ref(*map(jnp.asarray, (q, k, v, kp, qp, rows)),
                                     window=window)
        got = tref.flash_decode_ref(*map(torch.from_numpy, (q, k, v, kp)),
                                    torch.as_tensor(qp), torch.from_numpy(rows),
                                    window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("b,bc,c,kh,g,d,window,shared", ATTN_CASES)
    def test_plain_matches_pallas_bf16(self, b, bc, c, kh, g, d, window, shared):
        q, k, v, kp, qp, rows = _attn_case(b, bc, c, kh, g, d, c * d,
                                           shared_qpos=shared)
        (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
        want = np.asarray(flash_decode_pallas(
            jq, jk, jv, jnp.asarray(kp), jnp.asarray(qp), jnp.asarray(rows),
            window=window, block_c=32, interpret=True).astype(jnp.float32))
        got = ops.flash_decode(tq, tk, tv, torch.from_numpy(kp), torch.as_tensor(qp),
                               torch.from_numpy(rows), window=window).float().numpy()
        assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want) + 1e-5)

    def test_sentinel_row_reads_clamped_like_reference(self):
        """A row index past the cache reads the last row, as the reference's
        jnp gather clamps; torch's ``cache[rows]`` alone would raise."""
        q, k, v, kp, qp, rows = _attn_case(4, 6, 48, 2, 1, 32, 11, sentinel=True)
        assert rows[-1] == 6
        want = jref.flash_decode_ref(*map(jnp.asarray, (q, k, v, kp, qp, rows)))
        got = tref.flash_decode_ref(*map(torch.from_numpy, (q, k, v, kp, qp, rows)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)

    def test_fully_masked_row_averages_uniformly(self):
        q, k, v, kp, qp, rows = _attn_case(2, 2, 16, 1, 1, 8, 3)
        kp[:] = -1
        got = tref.flash_decode_ref(*map(torch.from_numpy, (q, k, v, kp, qp, rows)))
        want = v[rows].mean(axis=1)  # (B, Kh=1, D)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


class TestDispatch:
    def test_use_kernels_true_on_cpu_raises(self):
        with pytest.raises(RuntimeError, match="sm_90"):
            ops.resolve_use_kernels(True, "cpu")

    def test_auto_resolves_to_plain_on_cpu(self):
        assert ops.resolve_use_kernels(None, "cpu") is False
        assert ops.resolve_use_kernels(False, "cpu") is False

    @pytest.mark.parametrize("capability,flag,want", [
        ((9, 0), None, True),
        ((9, 0), True, True),
        ((9, 0), False, False),
        ((8, 0), None, RuntimeError),
        ((8, 0), True, RuntimeError),
        ((8, 0), False, False),
    ])
    def test_cuda_resolution(self, monkeypatch, capability, flag, want):
        """On a CUDA device None means the kernels; a card that is not
        sm_90 raises unless the caller asks for the plain versions."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_capability",
                            lambda device=None: capability)
        if want is RuntimeError:
            with pytest.raises(RuntimeError, match="sm_90"):
                ops.resolve_use_kernels(flag, "cuda:0")
        else:
            assert ops.resolve_use_kernels(flag, "cuda:0") is want

    def test_no_device_without_cuda_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ops.resolve_device(None)
        with pytest.raises(RuntimeError):
            ops.resolve_device("cuda")
        assert ops.resolve_device("cpu") == torch.device("cpu")

    def test_kernel_sources_present_and_unbuilt_at_import(self):
        for name in build.KERNEL_SOURCES:
            src = build.source_path(name)
            assert src.is_file()
            assert 'extern "C"' in src.read_text()
        assert build._loaded == {}


# ------------------------------------------------- the kernel's split plan
def _split_merge(q, k, v, k_pos, q_pos, rows, window=0):
    """Test-side emulation of the Hopper kernel's algorithm, in fp32: the
    cache's C slots in the launcher's fixed splits, a partial (m, l, acc)
    over each split's valid slots only (an empty partial where it has
    none), the partials merged in split order, and a row whose splits are
    all empty averaging V uniformly over all C slots."""
    b, h, d = q.shape
    bc, c, kh, _ = k.shape
    g = h // kh
    split, splits = split_plan(c)
    r = rows.long().clamp(0, bc - 1)
    kk, vv, kp = k[r].float(), v[r].float(), k_pos[r]
    qp = q_pos[:, None]
    valid = (kp >= 0) & (kp <= qp)
    if window > 0:
        valid &= qp - kp < window
    qf = q.float().reshape(b, kh, g, d) * (1.0 / math.sqrt(d))
    s = torch.einsum("bkgd,bckd->bkgc", qf, kk)
    parts = []
    for sp in range(splits):
        lo, hi = sp * split, min(c, (sp + 1) * split)
        ok = valid[:, None, None, lo:hi]
        m = torch.where(ok, s[..., lo:hi], -math.inf).amax(-1)  # -inf: empty
        w = torch.where(ok, torch.exp(s[..., lo:hi] - m[..., None]), 0.0)
        parts.append((m, w.sum(-1), torch.einsum("bkgc,bckd->bkgd", w, vv[:, lo:hi])))
    mm = torch.stack([m for m, _, _ in parts]).amax(0)
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(parts[0][1])
    for m, l, acc in parts:  # split order; an empty split adds nothing
        f = torch.where(l > 0, torch.exp(m - mm), 0.0)
        den = den + l * f
        num = num + acc * f[..., None]
    empty = den == 0
    uniform = vv.mean(dim=1)[:, :, None, :].expand_as(num)
    out = torch.where(empty[..., None], uniform, num / den.clamp(min=1e-30)[..., None])
    return out.reshape(b, h, d)


def _split_case(kind, seed):
    """(q, k, v, k_pos, q_pos, rows, window) numpy inputs of one case."""
    rng = np.random.default_rng(seed)
    b, bc, c, kh, g, d, window = {
        "short": (4, 4, 2048, 2, 1, 32, 0),
        "straddle": (4, 4, 2048, 2, 1, 32, 0),
        "masked": (4, 4, 1024, 2, 1, 32, 0),
        "wrapped": (3, 4, 1100, 2, 1, 32, 0),
        "window": (3, 4, 1100, 2, 2, 32, 300),
        "sentinel": (4, 5, 1024, 2, 1, 64, 0),
        "b1": (1, 3, 1500, 2, 1, 32, 0),
    }[kind]
    q = rng.standard_normal((b, kh * g, d)).astype(np.float32)
    k = rng.standard_normal((bc, c, kh, d)).astype(np.float32)
    v = rng.standard_normal((bc, c, kh, d)).astype(np.float32)
    rows = rng.permutation(bc)[:b].astype(np.int32)
    slots = np.arange(c, dtype=np.int32)
    if kind in ("wrapped", "window"):
        # Ring after more than one lap: slot s holds the newest position
        # congruent to s, all at or before the row's q_pos.
        q_row = rng.integers(c + 50, 3 * c, bc).astype(np.int32)
        k_pos = (q_row[:, None] - (q_row[:, None] - slots) % c).astype(np.int32)
    else:
        # Short valid ranges in a long cache: positions 0..q_pos, -1 beyond.
        q_row = rng.integers(20, 60, bc).astype(np.int32)
        if kind == "straddle":  # valid ranges across a split boundary
            q_row += SPLIT - 40
        if kind == "b1":
            q_row[:] = c - 1
        k_pos = np.where(slots <= q_row[:, None], slots, -1).astype(np.int32)
        k_pos[rng.random((bc, c)) < 0.1] = -1  # holes
    q_pos = q_row[np.minimum(rows, bc - 1)].copy()
    if kind == "masked":
        k_pos[rows[1]] = -1  # one fully masked row
    if kind == "sentinel":
        rows[-1] = bc  # the compacted runtime's out-of-bounds sentinel
    return q, k, v, k_pos, q_pos, rows, window


SPLIT_KINDS = ["short", "straddle", "masked", "wrapped", "window", "sentinel", "b1"]


class TestFlashDecodeSplit:
    """The kernel's split-and-merge algorithm, emulated here with the
    launcher's own split plan, against the reference oracle and the Pallas
    kernel (the kernel itself runs only on the card)."""

    def test_plan_depends_on_c_only(self):
        assert split_plan(4096) == (SPLIT, 8)
        assert split_plan(1) == (SPLIT, 1)
        assert split_plan(SPLIT + 1) == (SPLIT, 2)

    @pytest.mark.parametrize("kind", SPLIT_KINDS)
    def test_emulation_matches_reference_fp32(self, kind):
        q, k, v, kp, qp, rows, window = _split_case(kind, seed=len(kind))
        want = tref.flash_decode_ref(*map(torch.from_numpy, (q, k, v, kp, qp, rows)),
                                     window=window)
        got = _split_merge(*map(torch.from_numpy, (q, k, v, kp, qp, rows)), window)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
        jwant = jref.flash_decode_ref(*map(jnp.asarray, (q, k, v, kp, qp, rows)),
                                      window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(jwant), rtol=0, atol=1e-5)

    @pytest.mark.parametrize("kind", SPLIT_KINDS)
    def test_emulation_matches_pallas_bf16(self, kind):
        q, k, v, kp, qp, rows, window = _split_case(kind, seed=7 * len(kind))
        (jq, tq), (jk, tk), (jv, tv) = _bf16(q), _bf16(k), _bf16(v)
        c = k.shape[1]
        block_c = next(bl for bl in (256, 100, 300) if c % bl == 0)
        # The Pallas kernel is given the clamped rows the reference gathers.
        jrows = np.minimum(rows, k.shape[0] - 1)
        want = np.asarray(flash_decode_pallas(
            jq, jk, jv, jnp.asarray(kp), jnp.asarray(qp), jnp.asarray(jrows),
            window=window, block_c=block_c, interpret=True).astype(jnp.float32))
        got = _split_merge(tq, tk, tv, torch.from_numpy(kp), torch.from_numpy(qp),
                           torch.from_numpy(rows), window).bfloat16().float().numpy()
        assert np.all(np.abs(got - want) <= BF16_ULP * np.abs(want) + 1e-5)
