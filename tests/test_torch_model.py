"""The port's dense GQA model against the reference package on the CPU.

Fixture: the ``phi3_mini_3_8b`` smoke config with ``num_layers=4,
branch_layers=(1, 3)``, weights from ``repro.models.model.init_params``
carried over by ``repro_torch.bridge``.

Tolerances:
  * fp32 compute (``dtype="float32"``): 1e-4 — the two frameworks sum the
    same fp32 products in different orders;
  * bf16 compute (the serving dtype): rtol = atol = 2^-5, four bf16 ulps
    at unit scale (the reference's own bf16 tolerance is 2e-2,
    ``tests/test_kernels.py``; RoPE turns an ulp of a large component into
    an absolute error on a small one, hence atol at unit scale).  A bf16
    product differs by one ulp in a few outputs across frameworks and that
    spreads through the layers, so values agree by tolerance, not bitwise;
  * slot validity (``pos``) and step counters: exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import ModelConfig
from repro_torch.models import attention as TA
from repro_torch.models import model as TM

BF16_TOL = dict(rtol=2.0 ** -5, atol=2.0 ** -5)
FP32_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(dtype):
    jcfg = dataclasses.replace(get_smoke_config("phi3_mini_3_8b"), num_layers=4,
                               branch_layers=(1, 3), dtype=dtype)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs("bfloat16")
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _np(tree):
    return jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree)


def _prefill_both(weights, dtype, batch=4, plen=9, cap=32):
    jp, tp = weights
    jcfg, tcfg = _cfgs(dtype)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (batch, plen)).astype(np.int32)
    jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                        JM.init_caches(jcfg, batch, cap))
    tl, tc = TM.prefill(tp, torch.from_numpy(toks).long(), tcfg,
                        TM.init_caches(tcfg, batch, cap, device="cpu"))
    return (jcfg, tcfg), (jl, jc), (tl, tc)


def _assert_caches(jc, tc, tol):
    jn, tn = _np(jc), bridge.caches_to_numpy(tc)
    for k in ("k", "v"):
        np.testing.assert_allclose(tn["blocks"]["self"][k], jn["blocks"]["self"][k], **tol)
    np.testing.assert_array_equal(tn["blocks"]["self"]["pos"], jn["blocks"]["self"]["pos"])
    np.testing.assert_array_equal(tn["blocks"]["self"]["length"], jn["blocks"]["self"]["length"])
    np.testing.assert_array_equal(tn["length"], jn["length"])


class TestBridge:
    def test_params_round_trip_bitwise(self, weights):
        jp, tp = weights
        back = bridge.caches_to_numpy(tp)
        flat_j = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
        assert len(flat_j) == len(jax.tree_util.tree_leaves(back))
        for path, a in flat_j:
            b = back
            for key in path:
                b = b[key.key]
            assert b.dtype == np.float32 and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)

    def test_bf16_caches_round_trip_exactly(self):
        jcfg, _ = _cfgs("bfloat16")
        jc = JM.init_caches(jcfg, 2, 8)
        vals = jax.random.normal(jax.random.PRNGKey(1), jc["blocks"]["self"]["k"].shape)
        jc["blocks"]["self"]["k"] = vals.astype(jnp.bfloat16)
        tc = bridge.caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
        assert tc["blocks"]["self"]["k"].dtype == torch.bfloat16
        np.testing.assert_array_equal(bridge.caches_to_numpy(tc)["blocks"]["self"]["k"],
                                      _np(jc)["blocks"]["self"]["k"])


class TestPrefill:
    @pytest.mark.parametrize("dtype,tol", [("float32", FP32_TOL), ("bfloat16", BF16_TOL)])
    def test_logits_and_caches_match(self, weights, dtype, tol):
        _, (jl, jc), (tl, tc) = _prefill_both(weights, dtype)
        np.testing.assert_allclose(tl.float().numpy(),
                                   np.asarray(jl.astype(jnp.float32)), **tol)
        _assert_caches(jc, tc, tol)

    def test_prefill_rows_drops_sentinels_and_resets_tails(self, weights):
        """Admission prefill into rows (2, 0) of a 4-row cache with one
        out-of-bounds sentinel: matches the reference's ``mode="drop"``."""
        jp, tp = weights
        jcfg, tcfg = _cfgs("float32")
        (_, _), (_, jc), (_, tc) = _prefill_both(weights, "float32", plen=12, cap=16)
        toks = np.random.default_rng(3).integers(0, 512, (4, 5)).astype(np.int32)
        rows = np.array([2, 0, 4, 4], np.int32)
        jl, jc = JM.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg, jc,
                            rows=jnp.asarray(rows))
        tl, tc = TM.prefill(tp, torch.from_numpy(toks).long(), tcfg, tc, rows=rows)
        np.testing.assert_allclose(tl.float().numpy()[:2], np.asarray(jl)[:2], **FP32_TOL)
        _assert_caches(jc, tc, FP32_TOL)


class TestDecode:
    @pytest.mark.parametrize("dtype,tol", [("float32", FP32_TOL), ("bfloat16", BF16_TOL)])
    def test_decode_step_matches(self, weights, dtype, tol):
        jp, tp = weights
        (jcfg, tcfg), (jl, jc), (tl, tc) = _prefill_both(weights, dtype)
        tok = np.argmax(np.asarray(jl[:, 0].astype(jnp.float32)), -1)[:, None].astype(np.int32)
        jo = JM.decode_step(jp, jnp.asarray(tok), jnp.asarray(9), jc, jcfg, use_kernels=False)
        to = TM.decode_step(tp, torch.from_numpy(tok).long(), 9, tc, tcfg)
        np.testing.assert_allclose(to["logits"].float().numpy(),
                                   np.asarray(jo["logits"].astype(jnp.float32)), **tol)
        for layer in jcfg.branch_layers:
            np.testing.assert_allclose(to["branch_entropy"][layer].numpy(),
                                       np.asarray(jo["branch_entropy"][layer]),
                                       rtol=0, atol=1e-4)
        _assert_caches(jo["caches"], to["caches"], tol)

    @pytest.mark.parametrize("per_row", [False, True])
    def test_run_trunk_with_rows_matches(self, weights, per_row):
        """Compacted decode: a 3-row sub-batch (one out-of-bounds sentinel)
        runs layers [1, 4) against rows of the 4-row resident cache, with
        lock-step or per-row positions, collecting branch 3."""
        jp, tp = weights
        (jcfg, tcfg), (_, jc), (_, tc) = _prefill_both(weights, "float32")
        rng = np.random.default_rng(7)
        h = rng.standard_normal((3, 1, jcfg.d_model)).astype(np.float32)
        rows = np.array([3, 1, 4], np.int32)
        if per_row:
            jpos, tpos = jnp.asarray([[9], [11], [10]]), torch.tensor([[9], [11], [10]])
        else:
            jpos, tpos = jnp.asarray([9]), torch.tensor([9])
        jh, jc, _, jcol = JM.run_trunk(jp, jnp.asarray(h), jcfg, jpos, jc,
                                      layer_range=(1, 4), collect=(3,),
                                      rows=jnp.asarray(rows))
        th, tc, _, tcol = TM.run_trunk(tp, torch.from_numpy(h), tcfg, tpos, tc,
                                       layer_range=(1, 4), collect=(3,),
                                       rows=torch.from_numpy(rows).long())
        np.testing.assert_allclose(th.numpy()[:2], np.asarray(jh)[:2], **FP32_TOL)
        np.testing.assert_allclose(tcol[3].numpy()[:2], np.asarray(jcol[3])[:2], **FP32_TOL)
        _assert_caches(jc, tc, FP32_TOL)


class TestDefaultDevice:
    """Entry points default to the current CUDA device: with none present
    and no ``device`` given, they raise."""

    @pytest.mark.parametrize("entry", ["init_params", "init_caches",
                                       "init_kv_cache", "params_from_jax"])
    def test_no_device_without_cuda_raises(self, monkeypatch, entry):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        _, tcfg = _cfgs("float32")
        call = {
            "init_params": lambda: TM.init_params(tcfg, torch.Generator()),
            "init_caches": lambda: TM.init_caches(tcfg, 2, 8),
            "init_kv_cache": lambda: TA.init_kv_cache(2, 8, 1, 4),
            "params_from_jax": lambda: bridge.params_from_jax(
                {"w": np.zeros(3, np.float32)}),
        }[entry]
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


class TestCacheWrite:
    def test_sentinel_writes_drop_and_real_rows_land(self):
        cache = TA.init_kv_cache(4, 6, 1, 2, torch.float32, "cpu")
        k_new = torch.arange(6, dtype=torch.float32).reshape(3, 1, 1, 2) + 1
        rows = torch.tensor([2, 4, 0])  # 4 = out-of-bounds sentinel
        TA._cache_write(cache, {"k": k_new, "v": -k_new}, rows,
                        torch.tensor([[7], [8], [9]]))
        assert cache["pos"].tolist() == [
            [-1, -1, -1, 9, -1, -1], [-1] * 6, [-1, 7, -1, -1, -1, -1], [-1] * 6]
        assert cache["k"][2, 1, 0].tolist() == [1.0, 2.0]
        assert cache["v"][0, 3, 0].tolist() == [-5.0, -6.0]
        assert int(cache["k"].count_nonzero()) == 4
        assert int(cache["length"]) == 1
