"""The port's Mamba2 / SSD kernels' plain versions and its Mamba2 and
Zamba2 models against the reference package on the CPU.

Kernels: the port's plain versions (``repro_torch.kernels.ref``, which its
dispatch wrappers run for CPU tensors) against the reference's jnp oracles
(``repro.kernels.ref``) and its Pallas kernels in interpret mode, on the
same numpy inputs.  The Hopper kernels themselves run only on the card
(``chip_smoke.py`` holds them against these plain versions).

Model: ``mamba_apply`` in all four branches (plain prefill, prefill from a
state, row-targeted admission prefill, lock-step and compacted decode) on
both the plain and the kernel path, and whole-model prefill / decode of the
``mamba2_130m`` and ``zamba2_1_2b`` smoke configs (``num_layers=4,
branch_layers=(1, 3)``, ``attn_every=2`` for Zamba2) on bridged weights.

Tolerances (all fp32):
  * SSD scan / step: rtol = atol = 2e-4, the reference's own fp32
    tolerance for its SSD kernels (``tests/test_kernels.py``): the chunked
    and sequential forms sum in different orders;
  * entropy |dH| <= 1e-5 (fp32 log-softmax sums vs the online form);
  * models and ``mamba_apply``: 1e-4 — the two frameworks sum the same fp32
    products in different orders;
  * state rows a step must not touch, slot validity and step counters:
    exact.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.kernels import ref as jref
from repro.kernels.entropy_exit import entropy_exit_pallas
from repro.kernels.ssd_scan import ssd_scan_pallas, ssd_update_pallas
from repro.models import mamba as JMB
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import ModelConfig, get_config, get_smoke_config as tsmoke
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import mamba as TMB
from repro_torch.models import model as TM

SSD_TOL = dict(rtol=2e-4, atol=2e-4)
FP32_TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _flat(tree, prefix=""):
    """{path: (shape, dtype name)} of a nested dict of arrays or tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).removeprefix("torch."))
    return out


# ====================================================================== SSD
UPDATE_CASES = [
    # bc, b, h, p, n, g, sentinel
    (4, 4, 4, 64, 32, 4, False),  # full batch, G == H
    (6, 3, 4, 64, 32, 2, True),  # compacted sub-batch, grouped B/C
    (8, 2, 24, 64, 128, 1, True),  # mamba2-130m head shape, 1 group
    (5, 5, 2, 128, 64, 2, False),
    (8, 5, 64, 64, 64, 1, True),  # zamba2-1.2b head shape, compacted
]


def _update_case(bc, b, h, p, n, g, sentinel, seed):
    rng = np.random.default_rng(seed)
    hs = rng.standard_normal((bc, h, p, n)).astype(np.float32)
    x = (rng.standard_normal((b, h, p)) * 0.5).astype(np.float32)
    a = (-np.abs(rng.standard_normal((b, h))) * 0.3).astype(np.float32)
    bv = (rng.standard_normal((b, g, n)) * 0.5).astype(np.float32)
    cv = (rng.standard_normal((b, g, n)) * 0.5).astype(np.float32)
    rows = rng.permutation(bc)[:b].astype(np.int32)
    if sentinel:
        rows[-1] = bc  # the compacted runtime's out-of-bounds sentinel
    return hs, x, a, bv, cv, rows


class TestSSDUpdate:
    @pytest.mark.parametrize("bc,b,h,p,n,g,sentinel", UPDATE_CASES)
    def test_in_place_step_matches_reference(self, bc, b, h, p, n, g, sentinel):
        """The port's in-place contract against the reference's dense rows
        scattered with ``mode="drop"``; rows not named stay bitwise."""
        hs, x, a, bv, cv, rows = _update_case(bc, b, h, p, n, g, sentinel,
                                              seed=bc * b + h)
        jrows = jnp.asarray(rows)
        jargs = tuple(map(jnp.asarray, (hs, x, a, bv, cv)))
        yj, hj = jref.ssd_update_ref(*jargs, jrows)
        want = jargs[0].at[jrows].set(hj, mode="drop")
        yp, hp = ssd_update_pallas(*jargs, jrows, interpret=True)
        state = _t(hs.copy())
        ops.reset_launches()
        y = ops.ssd_update(state, _t(x), _t(a), _t(bv), _t(cv), _t(rows))
        assert ops.launches["ssd_update"] == 0  # CPU: the plain version
        live = rows < bc
        np.testing.assert_allclose(y.numpy()[live], np.asarray(yj)[live], **SSD_TOL)
        np.testing.assert_allclose(y.numpy()[live], np.asarray(yp)[live], **SSD_TOL)
        np.testing.assert_allclose(state.numpy(), np.asarray(want), **SSD_TOL)
        np.testing.assert_allclose(
            state.numpy(), np.asarray(jnp.asarray(hs).at[jrows].set(hp, mode="drop")),
            **SSD_TOL)
        untouched = np.setdiff1d(np.arange(bc), rows)
        np.testing.assert_array_equal(state.numpy()[untouched], hs[untouched])

    def test_rows_none_is_identity_map(self):
        hs, x, a, bv, cv, _ = _update_case(4, 4, 4, 64, 32, 2, False, seed=3)
        s1, s2 = _t(hs.copy()), _t(hs.copy())
        y1 = tref.ssd_update_ref(s1, _t(x), _t(a), _t(bv), _t(cv))
        y2 = tref.ssd_update_ref(s2, _t(x), _t(a), _t(bv), _t(cv),
                                 torch.arange(4, dtype=torch.int32))
        assert torch.equal(y1, y2) and torch.equal(s1, s2)

    def test_matches_model_step(self):
        """The kernel's plain version and the model's own ``ssd_step`` on
        gathered rows agree bitwise (one definition, two call sites)."""
        hs, x, a, bv, cv, rows = _update_case(6, 3, 4, 64, 32, 2, False, seed=9)
        state = _t(hs.copy())
        y = tref.ssd_update_ref(state, _t(x), _t(a), _t(bv), _t(cv), _t(rows))
        ys, hn = TMB.ssd_step(_t(hs)[_t(rows).long()], _t(x), _t(a), _t(bv), _t(cv))
        assert torch.equal(y, ys)
        assert torch.equal(state[_t(rows).long()], hn)


SCAN_CASES = [
    # b, l, h, p, n, chunk
    (2, 64, 4, 64, 32, 16),
    (1, 100, 2, 128, 64, 32),  # ragged tail
    (2, 256, 3, 64, 128, 128),
    (1, 128, 24, 64, 128, 64),  # mamba2-130m block shape
]


def _scan_inputs(b, l, h, p, n, g, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, l, h, p)) * 0.5).astype(np.float32)
    a = (-np.abs(rng.standard_normal((b, l, h))) * 0.3).astype(np.float32)
    bm = (rng.standard_normal((b, l, g, n)) * 0.5).astype(np.float32)
    cm = (rng.standard_normal((b, l, g, n)) * 0.5).astype(np.float32)
    return x, a, bm, cm


class TestSSDScan:
    @pytest.mark.parametrize("b,l,h,p,n,chunk", SCAN_CASES)
    def test_plain_matches_reference(self, b, l, h, p, n, chunk):
        """Per-head B/C (G = H) is exactly the reference kernel's function."""
        x, a, bm, cm = _scan_inputs(b, l, h, p, n, h, seed=l * h)
        y, hf = ops.ssd_scan(_t(x), _t(a), _t(bm), _t(cm), chunk=chunk)
        jx, ja, jb, jc = map(jnp.asarray, (x, a, bm, cm))
        yr, hr = jref.ssd_scan_ref(jx, ja, jb, jc)
        yk, hk = ssd_scan_pallas(jx, ja, jb, jc, chunk=chunk, interpret=True)
        for want_y, want_h in ((yr, hr), (yk, hk)):
            np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD_TOL)
            np.testing.assert_allclose(hf.numpy(), np.asarray(want_h), **SSD_TOL)

    @pytest.mark.parametrize("g", [1, 2])
    def test_grouped_matches_chunked_both_sides(self, g):
        """B/C per group (``rep = H / G``), as the model hands them over,
        against the reference's and the port's chunked scans, with and
        without an initial state."""
        b, l, h, p, n, chunk = 2, 96, 4, 64, 32, 32
        x, a, bm, cm = _scan_inputs(b, l, h, p, n, g, seed=g)
        h0 = np.random.default_rng(7).standard_normal((b, h, p, n)).astype(np.float32)
        y, hf = tref.ssd_scan_ref(_t(x), _t(a), _t(bm), _t(cm))
        for init in (None, h0):
            yj, hj = JMB.ssd_chunked(*map(jnp.asarray, (x, a, bm, cm)), chunk,
                                     h0=None if init is None else jnp.asarray(init))
            yt, ht = TMB.ssd_chunked(_t(x), _t(a), _t(bm), _t(cm), chunk,
                                     h0=None if init is None else _t(init))
            np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **FP32_TOL)
            np.testing.assert_allclose(ht.numpy(), np.asarray(hj), **FP32_TOL)
            if init is None:
                np.testing.assert_allclose(y.numpy(), np.asarray(yj), **SSD_TOL)
                np.testing.assert_allclose(hf.numpy(), np.asarray(hj), **SSD_TOL)
        yh, hh = tref.ssd_scan_ref(_t(x), _t(a), _t(bm), _t(cm), _t(h0))
        yj, hj = jref.ssd_scan_ref(*map(jnp.asarray, (
            x, a, np.repeat(bm, h // g, 2), np.repeat(cm, h // g, 2), h0)))
        np.testing.assert_allclose(yh.numpy(), np.asarray(yj), **SSD_TOL)
        np.testing.assert_allclose(hh.numpy(), np.asarray(hj), **SSD_TOL)


# ------------------------------------------- the scan kernel's 3xTF32 plan
def _tf32(t: torch.Tensor) -> torch.Tensor:
    """Round to the nearest TF32 value (ties away from zero) as the kernel
    does: add half a TF32 ulp to the bits, then mask the low 13 mantissa
    bits off."""
    return ((t.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, split: bool) -> torch.Tensor:
    """a @ b as the kernel's tensor-core products: with ``split`` the
    3xTF32 form lo*hi + hi*lo + hi*hi (hi the TF32 of the value, lo the
    TF32 of the exact remainder; an operand exact in TF32, as bf16 B and C
    are, has lo = 0), else one TF32 product.  fp32 accumulation."""
    ah, bh = _tf32(a), _tf32(b)
    if not split:
        return ah @ bh
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def _chunked_tf32(x, a, bm, cm, split=True, chunk=64):
    """Test-side emulation of the scan kernel: the chunked SSD form of
    ``ssd_scan_pallas`` over 64-token chunks, zero padded, with every
    product taken through :func:`_mm_tf32`."""
    bsz, l, h, p = x.shape
    g, n = bm.shape[2:]
    pad = (-l) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        bm = torch.nn.functional.pad(bm, (0, 0, 0, 0, 0, pad))
        cm = torch.nn.functional.pad(cm, (0, 0, 0, 0, 0, pad))
    xs, av = x.permute(0, 2, 1, 3), a.permute(0, 2, 1)  # (B, H, L, P), (B, H, L)
    bh = bm.float().repeat_interleave(h // g, 2).permute(0, 2, 1, 3)
    ch = cm.float().repeat_interleave(h // g, 2).permute(0, 2, 1, 3)
    state = torch.zeros((bsz, h, p, n))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool))
    ys = []
    for t0 in range(0, l + pad, chunk):
        xc, ac = xs[:, :, t0:t0 + chunk], av[:, :, t0:t0 + chunk]
        bc, cc = bh[:, :, t0:t0 + chunk], ch[:, :, t0:t0 + chunk]
        a_cum = torch.cumsum(ac, -1)
        decay = torch.exp(torch.where(tri, a_cum[..., :, None] - a_cum[..., None, :], -math.inf))
        m = _mm_tf32(cc, bc.transpose(-1, -2), split) * decay
        y = _mm_tf32(m, xc, split) + torch.exp(a_cum)[..., None] * _mm_tf32(
            cc, state.transpose(-1, -2), split)
        to_end = torch.exp(a_cum[..., -1:] - a_cum)
        state = torch.exp(a_cum[..., -1])[..., None, None] * state + _mm_tf32(
            (to_end[..., None] * xc).transpose(-1, -2), bc, split)
        ys.append(y)
    return torch.cat(ys, 2)[:, :, :l].permute(0, 2, 1, 3).contiguous(), state


def _chip_scan_inputs(b, l, h, p, n, g, seed, bf16_bc=True):
    """The chip check's input distribution: dt in [1e-3, 0.101], A in
    [1, 16], x = N(0, 1) dt, a = -dt A, B and C 0.5 N(0, 1) (bf16 values,
    as the model hands them over, unless ``bf16_bc`` is False)."""
    rng = np.random.default_rng(seed)
    dt = rng.random((b, l, h)).astype(np.float32) * 0.1 + 1e-3
    a_log = rng.random(h).astype(np.float32) * np.float32(math.log(16.0))
    x = rng.standard_normal((b, l, h, p)).astype(np.float32) * dt[..., None]
    a = (-dt * np.exp(a_log)).astype(np.float32)
    bc = torch.from_numpy((rng.standard_normal((2, b, l, g, n)) * 0.5).astype(np.float32))
    if bf16_bc:
        bc = bc.bfloat16().float()
    return _t(x), _t(a), bc[0].contiguous(), bc[1].contiguous()


TF32_CASES = [
    # b, l, h, p, n, g, bf16 B/C
    (2, 128, 4, 64, 64, 1, True),  # Zamba2-1.2B head shape
    (2, 100, 4, 64, 64, 1, True),  # ragged L
    (2, 128, 3, 64, 128, 1, True),  # Mamba2-130M head shape
    (2, 128, 4, 64, 64, 2, True),  # G = 2
    (1, 128, 2, 64, 64, 1, False),  # fp32 B/C: 3x products everywhere
]


class TestSSDScanTF32Plan:
    """The scan kernel's chunked form with 3xTF32 products, emulated here,
    held at the chip check's tolerances: 1e-5 of max|y| and max|h| against
    the sequential ``ssd_scan_ref``, 1e-4 against the chunked Pallas kernel
    (a different fp32 summation order of the same chunked algebra)."""

    @pytest.mark.parametrize("b,l,h,p,n,g,bf16_bc", TF32_CASES)
    def test_3xtf32_meets_chip_tolerances(self, b, l, h, p, n, g, bf16_bc):
        x, a, bm, cm = _chip_scan_inputs(b, l, h, p, n, g, seed=l + n + g,
                                         bf16_bc=bf16_bc)
        y, hf = _chunked_tf32(x, a, bm, cm)
        yr, hr = tref.ssd_scan_ref(x, a, bm, cm)
        ys, hs = float(yr.abs().max()), float(hr.abs().max())
        assert float((y - yr).abs().max()) <= 1e-5 * ys
        assert float((hf - hr).abs().max()) <= 1e-5 * hs
        rep = h // g
        yk, hk = ssd_scan_pallas(*map(jnp.asarray, (
            x.numpy(), a.numpy(), np.repeat(bm.numpy(), rep, 2),
            np.repeat(cm.numpy(), rep, 2))), chunk=64, interpret=True)
        assert float(np.abs(y.numpy() - np.asarray(yk)).max()) <= 1e-4 * ys
        assert float(np.abs(hf.numpy() - np.asarray(hk)).max()) <= 1e-4 * hs

    def test_single_tf32_misses_them(self):
        """One TF32 product per operand pair keeps ~11 bits: the same
        inputs miss the 1e-5 bound by orders of magnitude, so the split is
        required."""
        x, a, bm, cm = _chip_scan_inputs(2, 128, 4, 64, 64, 1, seed=193)
        y, hf = _chunked_tf32(x, a, bm, cm, split=False)
        yr, hr = tref.ssd_scan_ref(x, a, bm, cm)
        assert float((y - yr).abs().max()) > 10 * 1e-5 * float(yr.abs().max())
        assert float((hf - hr).abs().max()) > 10 * 1e-5 * float(hr.abs().max())



class TestEntropyExit:
    @pytest.mark.parametrize("v,pad", [(32000, 0), (50432, 152)])
    def test_plain_matches_reference(self, v, pad):
        """Zamba2's vocabulary, and Mamba2-130M's padded one whose 152 pad
        lanes carry -1e30 and still count in the log-width normalizer."""
        rng = np.random.default_rng(v)
        x = (rng.standard_normal((8, v)) * 4).astype(np.float32)
        if pad:
            x[:, -pad:] = -1e30
        jx = jnp.asarray(x).astype(jnp.bfloat16)
        tx = torch.from_numpy(x).bfloat16()
        thr = float(np.median(np.asarray(jref.entropy_exit_ref(jx, 0.5)[0])))
        h, flag = ops.entropy_exit(tx, thr)
        for hr, fr in (jref.entropy_exit_ref(jx, thr),
                       entropy_exit_pallas(jx, thr, interpret=True)):
            hr = np.asarray(hr)
            np.testing.assert_allclose(h.numpy(), hr, rtol=0, atol=1e-5)
            clear = np.abs(hr - thr) >= 1e-5
            np.testing.assert_array_equal(flag.numpy()[clear], np.asarray(fr)[clear])
        assert bool(flag.any()) and not bool(flag.all())

    def test_is_the_argmax_decision_without_token(self):
        x = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 999))
                             .astype(np.float32)).bfloat16()
        h, flag = ops.entropy_exit(x, 0.97)
        h2, flag2, _ = ops.entropy_exit_argmax(x, 0.97)
        assert torch.equal(h, h2) and torch.equal(flag, flag2)


# ================================================================ mamba_apply
def _cfgs(arch, dtype="float32"):
    kw = dict(num_layers=4, branch_layers=(1, 3), dtype=dtype)
    if arch == "zamba2_1_2b":
        kw["attn_every"] = 2
    jcfg = dataclasses.replace(get_smoke_config(arch), **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def mixer():
    """One Mamba2 mixer of the mamba2_130m smoke config (G = 1) and a
    random resident state of 5 rows."""
    jcfg, tcfg = _cfgs("mamba2_130m")
    jp = jax.jit(JMB.mamba_init, static_argnums=1)(jax.random.PRNGKey(3), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(4)
    st = jax.tree.map(np.asarray, JMB.init_ssm_state(5, jcfg))
    st = {"conv": rng.standard_normal(st["conv"].shape).astype(np.float32),
          "ssm": rng.standard_normal(st["ssm"].shape).astype(np.float32),
          "length": np.int32(7)}
    return jcfg, tcfg, jp, tp, st


def _state(st):
    return {k: torch.tensor(v) for k, v in st.items()}


def _jax_apply(cfg, jp, x, st=None, rows=None, use_kernels=False):
    """The reference mixer, jitted (eager JAX dispatch is slow on the CPU)."""
    fn = jax.jit(lambda p_, x_, st_, rows_: JMB.mamba_apply(
        p_, x_, cfg, st_, rows=rows_, use_kernels=use_kernels))
    return fn(jp, jnp.asarray(x), None if st is None else jax.tree.map(jnp.asarray, st),
              None if rows is None else jnp.asarray(rows))


def _assert_state(ts, js, tol=FP32_TOL):
    js = jax.tree.map(np.asarray, js)
    np.testing.assert_allclose(ts["conv"].numpy(), js["conv"], **tol)
    np.testing.assert_allclose(ts["ssm"].numpy(), js["ssm"], **tol)
    np.testing.assert_array_equal(ts["length"].numpy(), js["length"])


class TestMambaApply:
    def _x(self, cfg, b, s, seed):
        return np.random.default_rng(seed).standard_normal(
            (b, s, cfg.d_model)).astype(np.float32)

    def test_prefill_without_state(self, mixer):
        jcfg, tcfg, jp, tp, _ = mixer
        x = self._x(jcfg, 3, 37, seed=1)
        yj, _ = _jax_apply(jcfg, jp, x)
        yt, st = TMB.mamba_apply(tp, _t(x), tcfg)
        assert st is None
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **FP32_TOL)

    def test_prefill_from_state(self, mixer):
        jcfg, tcfg, jp, tp, st = mixer
        x = self._x(jcfg, 5, 21, seed=2)
        yj, sj = _jax_apply(jcfg, jp, x, st)
        ts = _state(st)
        yt, _ = TMB.mamba_apply(tp, _t(x), tcfg, ts)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **FP32_TOL)
        _assert_state(ts, sj)

    @pytest.mark.parametrize("use_kernels", [False, True])
    def test_row_targeted_prefill_starts_from_zero(self, mixer, use_kernels):
        """Admission: prompts 0 and 1 land in rows 3 and 0 from a fresh
        zero state; the sentinel row drops; rows 1, 2 and 4 and the step
        counter are untouched.  ``use_kernels`` takes the kernel path,
        whose wrappers run the plain versions for CPU tensors."""
        jcfg, tcfg, jp, tp, st = mixer
        x = self._x(jcfg, 3, 19, seed=3)
        rows = np.array([3, 0, 5], np.int32)
        yj, sj = _jax_apply(jcfg, jp, x, st, rows)
        ts = _state(st)
        yt, _ = TMB.mamba_apply(tp, _t(x), tcfg, ts, rows=rows,
                                use_kernels=use_kernels)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **FP32_TOL)
        _assert_state(ts, sj)
        for k in ("conv", "ssm"):
            np.testing.assert_array_equal(ts[k].numpy()[[1, 2, 4]], st[k][[1, 2, 4]])
        solo, _ = _jax_apply(jcfg, jp, x[:1])
        np.testing.assert_allclose(yt.numpy()[:1], np.asarray(solo), **FP32_TOL)

    @pytest.mark.parametrize("use_kernels", [False, True])
    def test_lockstep_decode(self, mixer, use_kernels):
        jcfg, tcfg, jp, tp, st = mixer
        x = self._x(jcfg, 5, 1, seed=4)
        yj, sj = _jax_apply(jcfg, jp, x, st, use_kernels=use_kernels)
        ts = _state(st)
        yt, _ = TMB.mamba_apply(tp, _t(x), tcfg, ts, use_kernels=use_kernels)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), **FP32_TOL)
        _assert_state(ts, sj)

    @pytest.mark.parametrize("use_kernels", [False, True])
    def test_compacted_decode(self, mixer, use_kernels):
        """A sub-batch of 3 over rows (4, 1, sentinel): the sentinel clamps
        its reads and drops its writes; rows 0, 2 and 3 stay bitwise."""
        jcfg, tcfg, jp, tp, st = mixer
        x = self._x(jcfg, 3, 1, seed=5)
        rows = np.array([4, 1, 5], np.int32)
        yj, sj = _jax_apply(jcfg, jp, x, st, rows, use_kernels=use_kernels)
        ts = _state(st)
        yt, _ = TMB.mamba_apply(tp, _t(x), tcfg, ts, rows=_t(rows),
                                use_kernels=use_kernels)
        np.testing.assert_allclose(yt.numpy()[:2], np.asarray(yj)[:2], **FP32_TOL)
        _assert_state(ts, sj)
        for k in ("conv", "ssm"):
            np.testing.assert_array_equal(ts[k].numpy()[[0, 2, 3]], st[k][[0, 2, 3]])


# ===================================================================== model
@pytest.fixture(scope="module", params=["mamba2_130m", "zamba2_1_2b"])
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


class TestModel:
    def test_configs_match_reference(self):
        from repro.configs import get_config as jget

        for arch in ("mamba2_130m", "zamba2_1_2b", "mamba2-130m", "zamba2-1.2b"):
            for port, ref in ((get_config(arch), jget(arch)),
                              (tsmoke(arch), get_smoke_config(arch))):
                assert dataclasses.asdict(port) == dataclasses.asdict(ref)
                assert (port.ssm_inner, port.is_attention_free) == \
                    (ref.ssm_inner, ref.is_attention_free)
        assert get_config("mamba2_130m").padded_vocab_size == 50432

    def test_layout_sites_and_params(self, model):
        jcfg, tcfg, jp, _ = model
        assert TM.hybrid_sites(tcfg) == JM.hybrid_sites(jcfg)
        assert [(n, k.mixer, k.mlp, c) for n, k, c in TM.trunk_layout(tcfg)] == \
            [(n, k.mixer, k.mlp, c) for n, k, c in JM.trunk_layout(jcfg)]
        ours = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
        assert _flat(ours) == _flat(jp)
        assert _flat(TM.init_caches(tcfg, 3, 16, device="cpu")) == \
            _flat(JM.init_caches(jcfg, 3, 16))

    def test_mamba_init_distributions(self):
        _, tcfg = _cfgs("mamba2_130m")
        p = TMB.mamba_init(dataclasses.replace(tcfg, ssm_num_heads=512), 2,
                           torch.Generator().manual_seed(0), "cpu")
        a = torch.exp(p["A_log"])
        dt = torch.nn.functional.softplus(p["dt_bias"])
        assert float(a.min()) >= 1.0 and float(a.max()) < 16.0
        assert float(dt.min()) >= 1e-3 * (1 - 1e-5) and float(dt.max()) <= 1e-1 * (1 + 1e-5)
        assert abs(float(p["conv_w"].std()) - 0.1) < 0.01
        assert torch.equal(p["D"], torch.ones_like(p["D"]))

    def test_prefill_and_decode_match_reference(self, model):
        jcfg, tcfg, jp, tp = model
        toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (4, 9)).astype(np.int32)
        jl, jc = jax.jit(JM.prefill, static_argnums=2)(
            jp, {"tokens": jnp.asarray(toks)}, jcfg, JM.init_caches(jcfg, 4, 32))
        jdecode = jax.jit(JM.decode_step, static_argnums=4)
        tl, tc = TM.prefill(tp, _t(toks).long(), tcfg,
                            TM.init_caches(tcfg, 4, 32, device="cpu"))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32_TOL)
        tok = np.random.default_rng(1).integers(0, jcfg.vocab_size, (4, 1)).astype(np.int32)
        for step in range(2):
            jo = jdecode(jp, jnp.asarray(tok), jnp.asarray(9 + step, jnp.int32),
                         jc, jcfg)
            to = TM.decode_step(tp, _t(tok).long(), torch.tensor(9 + step), tc, tcfg)
            np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]),
                                       **FP32_TOL)
            for layer in jcfg.branch_layers:
                np.testing.assert_allclose(to["branch_entropy"][layer].numpy(),
                                           np.asarray(jo["branch_entropy"][layer]),
                                           **FP32_TOL)
            jc, tc = jo["caches"], to["caches"]
            tok = np.asarray(jnp.argmax(jo["logits"], -1))[:, None].astype(np.int32)
        jn, tn = jax.tree.map(np.asarray, jc), bridge.caches_to_numpy(tc)
        _assert_state({k: torch.from_numpy(v) for k, v in tn["blocks"]["self"].items()},
                      {k: v for k, v in jn["blocks"]["self"].items()})
        np.testing.assert_array_equal(tn["blocks"]["self"]["length"],
                                      jn["blocks"]["self"]["length"])
        np.testing.assert_array_equal(tn["length"], jn["length"])
        if "shared_attn" in jn:
            sj, st = jn["shared_attn"]["self"], tn["shared_attn"]["self"]
            for k in ("k", "v"):
                np.testing.assert_allclose(st[k], sj[k], **FP32_TOL)
            for k in ("pos", "length"):
                np.testing.assert_array_equal(st[k], sj[k])

    def test_caches_bridge_bitwise(self, model):
        jcfg, tcfg, jp, _ = model
        toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 5)).astype(np.int32)
        _, jc = jax.jit(JM.prefill, static_argnums=2)(
            jp, {"tokens": jnp.asarray(toks)}, jcfg, JM.init_caches(jcfg, 2, 16))
        jn = jax.tree.map(np.asarray, jc)
        back = bridge.caches_to_numpy(bridge.caches_from_jax(jn, "cpu"))
        jax.tree.map(np.testing.assert_array_equal, back, jn)
