"""Qwen3-8B in the port (``configs/qwen3_8b.py``, qk-norm attention)
against the reference on the CPU, on bridged weights.

  * the config is field-identical to the reference's, published and smoke;
  * ``init_params`` keeps the reference's tree (``q_norm`` / ``k_norm``
    scales of width ``head_dim`` in every attention layer) and, as the
    reference under ``param_dtype="bfloat16"``, every leaf in bf16;
  * qk-norm attention (q and k normalized per head before RoPE and before
    the cache write): the prompt prefill and a decode step against the
    reference's ``attn_apply`` with non-unit norm scales, outputs and
    cache K within 1e-5 (fp32);
  * the whole model: prefill and decode logits and caches within 1e-4 in
    fp32 and 2^-5 in bf16 (the tolerances of ``test_torch_model.py``;
    bf16 K within 2^-4, two ulps at the normalized keys' magnitude);
  * a K=2 ``PartitionedServer`` run (the reduced config of
    ``examples/serve_partitioned.py``: 4 layers, branches 1 and 3) whose
    tokens, exit masks and bytes equal the reference's in fp32, logits
    within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.models import attention as JA
from repro.models import model as JM
from repro.serving import PartitionedServer as JPartitionedServer
from repro_torch import bridge
from repro_torch.configs import ARCH_IDS, ModelConfig, get_config, get_smoke_config
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.serving import PartitionedServer

BF16_TOL = dict(rtol=2.0 ** -5, atol=2.0 ** -5)
FP32_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(dtype="float32", **kw):
    jcfg = dataclasses.replace(j_get_smoke_config("qwen3_8b"), num_layers=4,
                               branch_layers=(1, 3), dtype=dtype, **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    # Non-unit qk-norm scales, so the norms' weights matter.
    r = np.random.default_rng(4)
    attn = dict(jp["blocks"]["attn"])
    for name in ("q_norm", "k_norm"):
        shape = attn[name]["scale"].shape
        attn[name] = {"scale": jnp.asarray(r.uniform(0.5, 1.5, shape), jnp.bfloat16)}
    jp = {**jp, "blocks": {**jp["blocks"], "attn": attn}}
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_config_is_the_reference_s():
    assert "qwen3_8b" in ARCH_IDS
    for port, ref in ((get_config("qwen3_8b"), j_get_config("qwen3_8b")),
                      (get_smoke_config("qwen3-8b"), j_get_smoke_config("qwen3_8b"))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    cfg = get_config("qwen3_8b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.use_qk_norm, cfg.rope_theta,
            cfg.branch_layers) == (36, 4096, 32, 8, 128, 12288, 151936, True, 1e6,
                                   (9, 18, 27))


def test_init_params_tree_and_dtype(weights):
    """The port's own init: the reference's tree, shapes and bf16 leaves."""
    jp, _ = weights
    _, tcfg = _cfgs()
    tp = TM.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")

    def shapes(tree, dtype_of):
        return {k: shapes(v, dtype_of) if isinstance(v, dict)
                else (tuple(v.shape), dtype_of(v)) for k, v in tree.items()}

    assert shapes(tp, lambda t: str(t.dtype).split(".")[-1]) == \
        shapes(jp, lambda a: str(a.dtype))
    assert tp["blocks"]["attn"]["q_norm"]["scale"].shape == (4, tcfg.head_dim)


@pytest.mark.parametrize("rows", [None, "rows"])
def test_qk_norm_attention(weights, rows):
    """One layer's attention: a prompt prefill into the cache, then a
    decode step over it (with a compacted ``rows`` map and a sentinel)."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    jl = jax.tree.map(lambda a: a[1], jp["blocks"]["attn"])
    tl = {k: {kk: vv[1] for kk, vv in v.items()} if isinstance(v, dict) else v[1]
          for k, v in tp["blocks"]["attn"].items()}
    tl = TM.compute_params(tl, torch.float32)
    r = np.random.default_rng(0)
    b, s, cap = 3, 6, 16
    x = r.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    jc = JA.init_kv_cache(b, cap, jcfg.num_kv_heads, jcfg.head_dim, jnp.float32)
    tc = TA.init_kv_cache(b, cap, tcfg.num_kv_heads, tcfg.head_dim, torch.float32, "cpu")
    jo, jc = JA.attn_apply(jl, jnp.asarray(x), jcfg, jnp.arange(s), jc)
    to, tc = TA.attn_apply(tl, torch.from_numpy(x), tcfg, torch.arange(s), tc)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), rtol=0, atol=1e-5)
    xd = r.standard_normal((2 if rows else b, 1, jcfg.d_model)).astype(np.float32)
    kw_j = kw_t = {}
    if rows:
        kw_j = dict(rows=jnp.asarray([2, b], jnp.int32))
        kw_t = dict(rows=torch.tensor([2, b], dtype=torch.int32))
    jo, jc = JA.attn_apply(jl, jnp.asarray(xd), jcfg, jnp.asarray([s]), jc, **kw_j)
    to, tc = TA.attn_apply(tl, torch.from_numpy(xd), tcfg, torch.tensor([s]), tc, **kw_t)
    np.testing.assert_allclose(to.numpy()[:1], np.asarray(jo)[:1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("dtype,tol", [("float32", FP32_TOL), ("bfloat16", BF16_TOL)])
def test_model_prefill_and_decode(weights, dtype, tol):
    jp, tp = weights
    jcfg, tcfg = _cfgs(dtype)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (4, 10)).astype(np.int32)
    jl, jc = jax.jit(JM.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks)}, jcfg, JM.init_caches(jcfg, 4, 16))
    tpc = TM.compute_params(tp, TM.compute_dtype(tcfg))
    tl, tc = TM.prefill(tpc, torch.from_numpy(toks).long(), tcfg,
                        TM.init_caches(tcfg, 4, 16, device="cpu"))
    np.testing.assert_allclose(tl.float().numpy(), np.asarray(jl.astype(jnp.float32)),
                               **tol)
    tok = np.argmax(np.asarray(jl[:, 0].astype(jnp.float32)), -1)[:, None].astype(np.int32)
    jo = JM.decode_step(jp, jnp.asarray(tok), jnp.asarray(10), jc, jcfg, use_kernels=False)
    to = TM.decode_step(tpc, torch.from_numpy(tok).long(), 10, tc, tcfg)
    np.testing.assert_allclose(to["logits"].float().numpy(),
                               np.asarray(jo["logits"].astype(jnp.float32)), **tol)
    # bf16 K: qk-norm scales each head to rms ~1 (|k| up to ~4) before
    # RoPE, so a one-ulp difference in a bf16 projection reaches the rotated
    # key as up to two ulps at that magnitude (2^-4).
    cache_tol = tol if dtype == "float32" else dict(rtol=2.0 ** -5, atol=2.0 ** -4)
    for name in ("k", "v"):
        np.testing.assert_allclose(
            to["caches"]["blocks"]["self"][name].float().numpy(),
            np.asarray(jo["caches"]["blocks"]["self"][name].astype(jnp.float32)),
            **cache_tol)


def test_served_k2_run_equals_the_reference(weights):
    """A K=2 run at split 2 (edge branch 1; branch 3 in the cloud tier is
    not evaluated), the threshold at the first step's median entropy:
    tokens, exits and bytes exact in fp32 over 6 steps."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    toks = np.array(jax.random.randint(jax.random.PRNGKey(2), (8, 1), 0,
                                       jcfg.vocab_size))
    probe = JPartitionedServer(jcfg, jp, 2, use_kernels=False)
    rep, _ = probe.step(jnp.asarray(toks), 0, JM.init_caches(jcfg, 8, 32))
    thr = float(np.median(rep.tier_result.branch_entropy[1]))
    jcfg, tcfg = _cfgs(exit_threshold=thr)
    js = JPartitionedServer(jcfg, jp, 2, use_kernels=False)
    ts = PartitionedServer(tcfg, tp, 2, device="cpu")
    jc, tc = JM.init_caches(jcfg, 8, 32), TM.init_caches(tcfg, 8, 32, device="cpu")
    jt, tt = jnp.asarray(toks), toks
    exits = 0
    for i in range(6):
        jr, jc = js.step(jt, i, jc)
        tr, tc = ts.step(tt, i, tc)
        np.testing.assert_array_equal(tr.tokens, np.asarray(jr.tokens))
        np.testing.assert_array_equal(tr.exited_on_edge, np.asarray(jr.exited_on_edge))
        assert (tr.shipped, tr.bytes_shipped) == (jr.shipped, jr.bytes_shipped)
        lg_t, lg_j = tr.tier_result.last_logits, jr.tier_result.last_logits
        live = ~tr.exited_on_edge
        np.testing.assert_allclose(lg_t.numpy()[live], np.asarray(lg_j)[live], **FP32_TOL)
        exits += int(tr.exited_on_edge.sum())
        jt, tt = jr.tier_result.tokens_dev[:, None], tr.tier_result.tokens_dev[:, None]
    assert 0 < exits < 6 * 8
