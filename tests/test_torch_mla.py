"""DeepSeek-V3's Multi-head Latent Attention and its two-stack trunk in the
port (``repro_torch.models.attention.mla_apply``, the ``dense_blocks`` /
``blocks`` stacks of ``deepseek_v3_671b``) against the reference package
on the CPU, on weights carried by ``repro_torch.bridge``, and the tier
runtime on latent rings.

Tolerances, each stated at its check:

  * ``mla_apply`` in fp32 compute: outputs and the latent ring's ``ckv``
    and ``k_rope`` within 1e-5 (rtol and atol, ``test_torch_moe.py``'s
    fp32 module tolerance); ``pos`` and ``length`` exact.  The absorbed
    decode against the naive expanded form inside the port: 1e-5;
  * ``mla_apply`` in bf16 compute: 2^-5 (rtol and atol, four bf16 ulps at
    unit scale, the port's bf16 model tolerance);
  * the smoke model in fp32: prefill and decode logits and branch
    entropies 1e-4 (the model tolerance of ``test_torch_moe.py``); a K=2
    ``PartitionedServer`` whose edge crosses the stack boundary step by
    step against the reference's: tokens, exits, bytes and buckets exact,
    logits 1e-4;
  * inside the port, in bf16: the overflow re-run, a recycled slot and
    ``reset_rows`` exact.

Graphed == eager and one host sync per step need a card: ``chip_smoke.py``
holds them on the full-width model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import profiler as JP
from repro.models import attention as JA
from repro.models import model as JM
from repro.serving import PartitionedServer as JPartitionedServer
from repro_torch import bridge
from repro_torch.configs import ModelConfig
from repro_torch.core import profiler as TP
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.serving import (
    PartitionedServer,
    ServingEngine,
    TierExecutor,
    segments_for_cuts,
)
from repro_torch.training.tree import tree_items

FP32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2.0 ** -5, atol=2.0 ** -5)
MODEL = dict(rtol=1e-4, atol=1e-4)
ARCH = "deepseek_v3_671b"
#: The served trunk at smoke width: 2 dense MLA layers, then 2 MoE layers;
#: a split at 3 puts the stack boundary inside the edge tier.
DEEP = dict(num_layers=4, first_k_dense=2, branch_layers=(1, 2))
SPLIT = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these shapes are small, and the test run's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    jcfg = dataclasses.replace(j_smoke(ARCH), **{"dtype": "float32",
                                                 "param_dtype": "float32", **kw})
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16
        else np.asarray(a), tree)


def _key(path) -> str:
    return "##".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


# ------------------------------------------------------------ mla_apply
@pytest.fixture(scope="module")
def mla_weights():
    jcfg, _ = _cfgs()
    jp = JA.mla_init(jax.random.PRNGKey(3), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _dirty_cache(jcfg, batch, cap, dtype, seed=4):
    """A latent ring holding an earlier occupant: random ``ckv`` and
    ``k_rope``, positions 0..cap-1 valid, ``length`` cap (both packages'
    trees, equal)."""
    r = np.random.default_rng(seed)
    jc = JA.init_mla_cache(batch, cap, jcfg, dtype)
    jc = dict(jc,
              ckv=jnp.asarray(r.standard_normal(jc["ckv"].shape), dtype),
              k_rope=jnp.asarray(r.standard_normal(jc["k_rope"].shape), dtype),
              pos=jnp.broadcast_to(jnp.arange(cap, dtype=jnp.int32), (batch, cap)),
              length=jnp.asarray(cap, jnp.int32))
    return jc, bridge.caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")


def _assert_ring(tc, jc, tol):
    tn, jn = bridge.caches_to_numpy(tc), _np(jc)
    for k in ("ckv", "k_rope"):
        np.testing.assert_allclose(tn[k], jn[k], **tol)
    np.testing.assert_array_equal(tn["pos"], jn["pos"])
    np.testing.assert_array_equal(tn["length"], jn["length"])


@pytest.mark.parametrize("cap", [16, 5], ids=["tail_kept", "wrapped"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_matches_reference(mla_weights, cap, dtype):
    """A 7-token prompt into a dirty ring of 16 slots (the slots past the
    prompt keep the earlier occupant's latent, as the reference's
    concatenation does) and of 5 (``s >= cap``: the newest 5 positions,
    rolled to slot = position % 5): output and ring within 1e-5 (fp32) or
    2^-5 (bf16), ``pos`` and ``length`` exact."""
    jp, tp = mla_weights
    jcfg, tcfg = _cfgs(dtype=dtype)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    x = np.random.default_rng(1).standard_normal((3, 7, jcfg.d_model)).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)
    jc, tc = _dirty_cache(jcfg, 3, cap, jd)
    jy, jc = JA.mla_apply(jp, jnp.asarray(x, jd), jcfg, jnp.asarray(pos), jc)
    ty, tc = TA.mla_apply(tp, _t(x).to(td), tcfg, _t(pos), tc)
    tol = FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), **tol)
    _assert_ring(tc, jc, tol)
    if cap == 5:
        assert tc["pos"][0].tolist() == [5, 6, 2, 3, 4]


def _decode_inputs(jcfg, mode, step, b):
    """(x, positions, rows) of decode step ``step`` in write mode ``mode``
    over a full batch of ``b`` rows whose prompts were 5 tokens."""
    r = np.random.default_rng(10 + step)
    if mode in ("rows_shared", "rows_per_seq"):
        # A survivor sub-batch: cache rows 3 and 0, then two sentinels.
        rows = np.array([3, 0, b, b + 2], np.int32)
    else:
        rows = None
    n = b if rows is None else rows.shape[0]
    x = r.standard_normal((n, 1, jcfg.d_model)).astype(np.float32)
    if mode in ("per_seq", "rows_per_seq"):
        # Each row at its own position (continuous batching).
        base = np.arange(n, dtype=np.int32) % 3
        positions = (5 + step + base)[:, None].astype(np.int32)
    else:
        positions = np.full((1,), 5 + step, np.int32)
    return x, positions, rows


@pytest.mark.parametrize("mode", ["shared", "per_seq", "rows_shared", "rows_per_seq"])
def test_mla_absorbed_decode_write_modes_match_reference(mla_weights, mode):
    """After a 5-token prefill into 8 slots, 5 absorbed decode steps
    (the ring wraps at position 8) in each of the reference's write modes:
    the lock-step write at ``length``, per-sequence ``(B, 1)`` positions,
    and a survivor sub-batch ``rows`` whose out-of-range sentinels drop
    their writes (shared and per-sequence positions).  Outputs of the
    real rows and the whole ring within 1e-5 in fp32; ``pos`` and
    ``length`` exact."""
    jp, tp = mla_weights
    jcfg, tcfg = _cfgs()
    b, cap = 4, 8
    x0 = np.random.default_rng(2).standard_normal((b, 5, jcfg.d_model)).astype(np.float32)
    pos0 = np.arange(5, dtype=np.int32)
    jc = JA.init_mla_cache(b, cap, jcfg, jnp.float32)
    tc = TA.init_mla_cache(b, cap, tcfg, torch.float32, "cpu")
    _, jc = JA.mla_apply(jp, jnp.asarray(x0), jcfg, jnp.asarray(pos0), jc)
    _, tc = TA.mla_apply(tp, _t(x0), tcfg, _t(pos0), tc)
    for step in range(5):
        x, positions, rows = _decode_inputs(jcfg, mode, step, b)
        jy, jc = JA.mla_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(positions), jc,
                              rows=None if rows is None else jnp.asarray(rows))
        ty, tc = TA.mla_apply(tp, _t(x), tcfg, _t(positions), tc,
                              rows=None if rows is None else _t(rows))
        real = slice(None) if rows is None else rows < b
        np.testing.assert_allclose(ty.numpy()[real], np.asarray(jy)[real], **FP32)
        _assert_ring(tc, jc, FP32)
    assert int(tc["length"]) == 10
    if rows is not None:  # rows 1 and 2 took no decode write
        assert tc["pos"][[1, 2]].max() == 4


def test_mla_prefill_rows_over_dirty_rows(mla_weights):
    """Row-targeted admission (``rows`` a host-side plan, a sentinel among
    them) into a ring dirtied by decode steps: each target row ends as a
    fresh solo prefill (stale tail slots reset to -1), the sentinel's
    prompt is dropped, the other rows and ``length`` are untouched — and
    the whole ring equals the reference's within 1e-5."""
    jp, tp = mla_weights
    jcfg, tcfg = _cfgs()
    b, cap = 4, 12
    jc, tc = _dirty_cache(jcfg, b, cap, jnp.float32)
    before = bridge.caches_to_numpy(tc)
    x = np.random.default_rng(6).standard_normal((3, 5, jcfg.d_model)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)
    rows = np.array([2, b + 3, 0])
    jy, jc = JA.mla_apply(jp, jnp.asarray(x), jcfg, jnp.asarray(pos), jc,
                          rows=jnp.asarray(rows))
    ty, tc = TA.mla_apply(tp, _t(x), tcfg, _t(pos), tc, rows=rows)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **FP32)
    _assert_ring(tc, jc, FP32)
    solo = TA.init_mla_cache(2, cap, tcfg, torch.float32, "cpu")
    TA.mla_apply(tp, _t(x[[0, 2]]), tcfg, _t(pos), solo)
    for leaf in ("ckv", "k_rope", "pos"):
        assert torch.equal(tc[leaf][[2, 0]], solo[leaf]), leaf
    assert tc["pos"][[2, 0], 5:].eq(-1).all()
    after = bridge.caches_to_numpy(tc)
    for leaf in ("ckv", "k_rope", "pos"):
        np.testing.assert_array_equal(after[leaf][[1, 3]], before[leaf][[1, 3]])
    assert int(tc["length"]) == cap


@pytest.mark.parametrize("window", [0, 4])
def test_absorbed_decode_equals_naive_form(mla_weights, window):
    """Inside the port: the absorbed decode of position 9 over a ring
    holding positions 0..8 equals, within 1e-5 in fp32, the last row of
    the naive expanded form (per-head K/V from the same latents through
    ``FlashAttention``) over positions 0..9; with a sliding window of 4
    too."""
    _, tp = mla_weights
    _, tcfg = _cfgs(sliding_window=window)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 10, tcfg.d_model)).astype(np.float32))
    naive, _ = TA.mla_apply(tp, x, tcfg, torch.arange(10))
    cache = TA.init_mla_cache(2, 16, tcfg, torch.float32, "cpu")
    TA.mla_apply(tp, x[:, :9], tcfg, torch.arange(9), cache)
    absorbed, _ = TA.mla_apply(tp, x[:, 9:], tcfg, torch.tensor([9]), cache)
    np.testing.assert_allclose(absorbed[:, 0].numpy(), naive[:, 9].numpy(), **FP32)


def test_prefill_attention_scale_is_explicit():
    """``prefill_attention`` and ``FlashAttention`` take the score scale as
    given, not from q's last dimension (MLA: 1/sqrt(hd + rope_dim)): a
    scale of 0.5 equals, within 1e-6, the default on queries rescaled to
    it; with none given they keep 1/sqrt(D), bitwise."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 6, 2, 1, 24, generator=g)
    k = torch.randn(1, 6, 2, 24, generator=g)
    v = torch.randn(1, 6, 2, 16, generator=g)
    pos = torch.arange(6)
    default = TA.prefill_attention(q, k, v, pos)
    assert torch.equal(default, TA.prefill_attention(q, k, v, pos, scale=24 ** -0.5))
    assert torch.equal(default, TA.FlashAttention.apply(q, k, v, pos, 0))
    other = TA.prefill_attention(q, k, v, pos, scale=0.5)
    assert not torch.equal(other, default) and other.shape == (1, 6, 2, 1, 16)
    np.testing.assert_allclose(
        other.numpy(), TA.prefill_attention(q * (0.5 * 24 ** 0.5), k, v, pos).numpy(),
        rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------ the model
@pytest.fixture(scope="module")
def model_weights():
    jcfg, _ = _cfgs(**DEEP)
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_bridge_round_trips_the_tree_and_latent_caches():
    """The DeepSeek-V3 tree (``dense_blocks``, ``blocks``, ``mtp_block``,
    ``mtp_norm``) in its configured bf16 params, and its latent caches
    holding values, carried to the port and back exactly."""
    jcfg, _ = _cfgs(param_dtype="bfloat16", dtype="bfloat16")
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert {"dense_blocks", "blocks", "mtp_block", "mtp_norm"} <= tp.keys()
    assert all(t.dtype == torch.bfloat16 for _, t in tree_items(tp))
    back = bridge.caches_to_numpy(tp)
    for p, a in jax.tree_util.tree_leaves_with_path(jp):
        node = back
        for k in _key(p).split("##"):
            node = node[k]
        np.testing.assert_array_equal(node, np.asarray(a.astype(jnp.float32)))
    jc = JM.init_caches(jcfg, 2, 8)
    r = np.random.default_rng(0)
    jc["blocks"]["self"]["ckv"] = jnp.asarray(
        r.standard_normal(jc["blocks"]["self"]["ckv"].shape), jnp.bfloat16)
    tc = bridge.caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    assert tc["blocks"]["self"]["ckv"].dtype == torch.bfloat16
    assert tc["dense_blocks"]["self"]["k_rope"].shape == (1, 2, 8, jcfg.mla_rope_dim)
    jax.tree.map(np.testing.assert_array_equal, bridge.caches_to_numpy(tc), _np(jc))


def test_prefill_then_decode_matches_reference(model_weights):
    """Prompts of 9 tokens into 16 slots, then 3 decode steps, through both
    stacks: logits and branch entropies within 1e-4 in fp32, every latent
    ring within 1e-4, ``pos`` and ``length`` exact."""
    jp, tp = model_weights
    jcfg, tcfg = _cfgs(**DEEP)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (3, 9)).astype(np.int32)
    jl, jc = jax.jit(JM.prefill, static_argnums=2)(
        jp, {"tokens": jnp.asarray(toks)}, jcfg, JM.init_caches(jcfg, 3, 16, jnp.float32))
    tpc = TM.compute_params(tp, torch.float32)
    tl, tc = TM.prefill(tpc, _t(toks).long(), tcfg,
                        TM.init_caches(tcfg, 3, 16, torch.float32, "cpu"))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **MODEL)
    decode = jax.jit(lambda p, t, i, c: JM.decode_step(p, t, i, c, jcfg, use_kernels=False))
    tok = np.argmax(np.asarray(jl[:, 0]), -1)[:, None].astype(np.int32)
    for i in range(3):
        jo = decode(jp, jnp.asarray(tok), jnp.asarray(9 + i), jc)
        to = TM.decode_step(tpc, _t(tok).long(), 9 + i, tc, tcfg)
        jc, tc = jo["caches"], to["caches"]
        np.testing.assert_allclose(to["logits"].numpy(), np.asarray(jo["logits"]), **MODEL)
        for layer in (1, 2):
            np.testing.assert_allclose(to["branch_entropy"][layer].numpy(),
                                       np.asarray(jo["branch_entropy"][layer]), **MODEL)
        tok = np.asarray(jo["logits"]).argmax(-1)[:, None].astype(np.int32)
    jn, tn = _np(jc), bridge.caches_to_numpy(tc)
    for stack in ("dense_blocks", "blocks"):
        for leaf in ("ckv", "k_rope"):
            np.testing.assert_allclose(tn[stack]["self"][leaf], jn[stack]["self"][leaf],
                                       **MODEL)
        for leaf in ("pos", "length"):
            np.testing.assert_array_equal(tn[stack]["self"][leaf], jn[stack]["self"][leaf])
    assert int(tc["length"]) == 12


def test_run_trunk_segments_at_the_stack_boundary(model_weights):
    """``layer_range`` (1, 3) runs one dense and one MoE layer: equal to
    the reference's run over the same range within 1e-4, and bitwise to
    the port's layers 2 and 3 run one range after the other."""
    jp, tp = model_weights
    jcfg, tcfg = _cfgs(**DEEP)
    x = np.random.default_rng(3).standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    pos = np.arange(6, dtype=np.int32)
    jh, _, jaux, _ = JM.run_trunk(jp, jnp.asarray(x), jcfg, jnp.asarray(pos),
                                  layer_range=(1, 3))
    th, _, taux, _ = TM.run_trunk(tp, _t(x), tcfg, _t(pos), layer_range=(1, 3))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **MODEL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    h2, _, _, _ = TM.run_trunk(tp, _t(x), tcfg, _t(pos), layer_range=(1, 2))
    h3, _, a3, _ = TM.run_trunk(tp, h2, tcfg, _t(pos), layer_range=(2, 3))
    assert torch.equal(h3, th) and torch.equal(torch.as_tensor(a3), torch.as_tensor(taux))


def test_served_k2_split_across_the_stacks_equals_the_reference(model_weights):
    """A K=2 ``PartitionedServer`` at split 3: the edge runs both dense
    layers and the first MoE layer and decides branches 1 and 2 in one
    exit launch; the cloud runs layer 4 on compacted buckets (the
    threshold between the first step's 6th and 7th smallest branch-1
    entropies, ``hint_window=1`` so its groups follow the survivors).  6 steps on
    identical batches: tokens, exits, bytes and buckets exact in fp32,
    logits 1e-4."""
    jp, tp = model_weights
    jcfg, _ = _cfgs(**DEEP)
    toks = np.array(jax.random.randint(jax.random.PRNGKey(2), (8, 1), 0, jcfg.vocab_size))
    probe = JPartitionedServer(jcfg, jp, SPLIT, use_kernels=False)
    rep, _ = probe.step(jnp.asarray(toks), 0, JM.init_caches(jcfg, 8, 32, jnp.float32))
    e = np.sort(rep.tier_result.branch_entropy[1])
    thr = float((e[5] + e[6]) / 2)
    jcfg, tcfg = _cfgs(**DEEP, exit_threshold=thr)
    js = JPartitionedServer(jcfg, jp, SPLIT, use_kernels=False, hint_window=1)
    ts = PartitionedServer(tcfg, tp, SPLIT, device="cpu", hint_window=1)
    assert ts.executor.segments[0].branches == (1, 2)
    jc = JM.init_caches(jcfg, 8, 32, jnp.float32)
    tc = TM.init_caches(tcfg, 8, 32, torch.float32, "cpu")
    jt, tt = jnp.asarray(toks), toks
    exits, buckets = 0, set()
    for i in range(6):
        jr, jc = js.step(jt, i, jc)
        tr, tc = ts.step(tt, i, tc)
        np.testing.assert_array_equal(tr.tokens, np.asarray(jr.tokens))
        np.testing.assert_array_equal(tr.exited_on_edge, np.asarray(jr.exited_on_edge))
        assert (tr.shipped, tr.bytes_shipped) == (jr.shipped, jr.bytes_shipped)
        live = ~tr.exited_on_edge
        np.testing.assert_allclose(tr.tier_result.last_logits.numpy()[live],
                                   np.asarray(jr.tier_result.last_logits)[live], **MODEL)
        assert [c.bucket for c in tr.tier_result.compaction] == \
            [c.bucket for c in jr.tier_result.compaction]
        exits += int(tr.exited_on_edge.sum())
        buckets |= {c.bucket for c in tr.tier_result.compaction}
        jt, tt = jr.tier_result.tokens_dev[:, None], tr.tier_result.tokens_dev[:, None]
    assert 0 < exits < 6 * 8
    assert min(buckets) < 8  # compacted cloud groups


# ------------------------------------------------------------ inside the port
def _bf16():
    return _cfgs(**DEEP, dtype="bfloat16")[1]


def _steps(tcfg, tp, steps, hints=None):
    """``steps`` lock-step decode steps of a K=2 executor at split 3 on
    8 rows; ``hints``: the cloud bucket planned at each step (1 forces an
    overflow re-run whenever more than one row survives)."""
    ex = TierExecutor(tcfg, tp, segments_for_cuts(tcfg, (SPLIT,)), device="cpu")
    caches = TM.init_caches(tcfg, 8, 16, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, tcfg.vocab_size, (8, 1)).astype(np.int32))
    out = []
    for i in range(steps):
        if hints is not None:
            ex._hints = {1: hints[i]}
        res, caches = ex.step(tok, i, caches)
        out.append(res)
        tok = res.tokens_dev[:, None]
    return ex, out, caches


@pytest.fixture(scope="module")
def mixed_threshold(model_weights):
    """The bf16 config at a threshold between the 4th and 5th smallest
    first-step branch-1 entropies: rows exit on the edge."""
    _, tp = model_weights
    _, out, _ = _steps(_bf16(), tp, 1)
    e = np.sort(out[0].branch_entropy[1])
    return dataclasses.replace(_bf16(), exit_threshold=float((e[3] + e[4]) / 2))


def test_overflow_rerun_restores_latent_rings_bitwise(model_weights, mixed_threshold):
    """A re-run restores the slot each latent ring of both stacks was
    written at (``ckv``, ``k_rope``, ``pos``) and every step counter: the
    trajectory and the final caches equal, bitwise, a run planned with the
    same buckets that never overflowed."""
    _, tp = model_weights
    tcfg = mixed_threshold
    exb, outb, cb = _steps(tcfg, tp, 3, hints=[1, 1, 1])
    used = [r.compaction[0].bucket for r in outb]
    exa, outa, ca = _steps(tcfg, tp, 3, hints=used)
    assert exa.overflow_retries == 0 < exb.overflow_retries
    assert exb.host_syncs == 3 + exb.overflow_retries
    for a, b in zip(outa, outb):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.exited, b.exited)
    jax.tree.map(np.testing.assert_array_equal, bridge.caches_to_numpy(ca),
                 bridge.caches_to_numpy(cb))


def test_snapshot_holds_the_latent_rings(model_weights):
    """The overflow snapshot lists both stacks' latent rings with their
    ``ckv``, ``k_rope`` and ``pos`` leaves (no Mamba2 state)."""
    _, tp = model_weights
    tcfg = _bf16()
    ex = TierExecutor(tcfg, tp, segments_for_cuts(tcfg, (SPLIT,)), device="cpu")
    caches = TM.init_caches(tcfg, 8, 16, device="cpu")
    rings, states = ex._stateful(caches)
    assert states == [] and len(rings) == 2
    saved, lengths = ex._snapshot(caches, torch.zeros(1, dtype=torch.int32))
    assert [sorted(vals) for _, _, vals in saved] == [["ckv", "k_rope", "pos"]] * 2
    assert len(lengths) == 3


def test_reset_rows_marks_latent_slots_empty(model_weights):
    """``reset_rows`` sets ``pos`` to -1 in the given rows of every latent
    ring of both stacks (sentinels ignored), leaves their latents and
    every other row as they were."""
    _, tp = model_weights
    tcfg = _bf16()
    ex, _, caches = _steps(tcfg, tp, 2)
    before = jax.tree.map(np.copy, bridge.caches_to_numpy(caches))
    ex.reset_rows(caches, np.array([1, 6, 8, 8]))  # two sentinels
    after = bridge.caches_to_numpy(caches)
    keep = [0, 2, 3, 4, 5, 7]
    for stack in ("dense_blocks", "blocks"):
        st, st0 = after[stack]["self"], before[stack]["self"]
        assert (st0["pos"][:, [1, 6]] >= 0).any()
        np.testing.assert_array_equal(st["pos"][:, [1, 6]], -1)
        np.testing.assert_array_equal(st["pos"][:, keep], st0["pos"][:, keep])
        for leaf in ("ckv", "k_rope", "length"):
            np.testing.assert_array_equal(st[leaf], st0[leaf])


@pytest.mark.parametrize("server", ["engine", "partitioned"])
def test_mla_moe_recycled_slot_matches_solo(model_weights, server):
    """The port's twin of the reference's
    ``test_mla_moe_recycled_slot_matches_solo``: a request admitted into
    a recycled slot of a 3-slot server mid-flight decodes exactly as it
    does alone (bf16) — its latent rows come from the row-targeted
    admission, its absorbed decode reads its own per-sequence positions —
    on the K=1 engine and on the K=2 server split across the stacks."""
    _, tp = model_weights
    tcfg = _bf16()
    r = np.random.default_rng(3)
    target = r.integers(0, tcfg.vocab_size, 5).astype(np.int32)
    fill = [np.random.default_rng(1 + i).integers(0, tcfg.vocab_size, 3).astype(np.int32)
            for i in range(4)]

    def run(busy):
        if server == "engine":
            srv = ServingEngine(tcfg, tp, context_len=32, slots=3, device="cpu")
        else:
            srv = PartitionedServer(tcfg, tp, SPLIT, device="cpu", slots=3,
                                    context_len=32)
        if busy:
            for p in fill:
                srv.submit(p, 2)
        rid = srv.submit(target, 4)
        srv.drain()
        res = srv.scheduler.results[rid]
        assert (res.admitted_step > 0) == busy
        return res

    solo, rec = run(False), run(True)
    assert (rec.tokens, rec.exited, rec.exit_tiers) == \
        (solo.tokens, solo.exited, solo.exit_tiers)


def test_analyze_decode_profile_across_both_stacks(model_weights):
    """``profile_decode_layers`` in analyze mode prices all 4 layers of
    both stacks over filled latent rings (positions 0..7 before the query
    at 8); each layer's FLOPs within 5% of XLA's count of the reference's
    lowering, the dense layers' equal, the MoE layers' above them."""
    jp, tp = model_weights
    jcfg, tcfg = _cfgs(**DEEP)
    b, c = 2, 16
    _, inputs = TP.decode_layer_fns(tcfg, tp, b, c)
    for stack in ("dense_blocks", "blocks"):
        ring = inputs[0][1][stack]["self"]
        assert ring["pos"][..., :8].eq(torch.arange(8)).all()
        assert ring["pos"][..., 8:].eq(-1).all() and ring["length"].eq(8).all()
    got = TP.profile_decode_layers(tcfg, tp, b, c, mode="analyze")
    xla = JP.profile_decode_layers(jcfg, jp, b, c, use_kernels=False, mode="analyze")
    assert [x.name for x in got] == [f"layer{i}" for i in range(1, 5)]
    for t, x in zip(got, xla):
        assert t.flops == pytest.approx(x.flops, rel=0.05)
        assert t.output_bytes == x.output_bytes == b * tcfg.d_model * 4
    assert got[0].flops == got[1].flops < got[2].flops == got[3].flops


def test_expert_stacks_are_the_fp32_draw_cast():
    """``init_params`` under bf16 params draws each MoE layer's expert leaf
    in fp32 and casts it as it is copied into the stack (at DeepSeek-V3's
    width one layer's fp32 leaf, 15 GB, is the only transient): every leaf
    bitwise the fp32 draw from the same seed, cast afterwards."""
    _, tcfg = _cfgs(**DEEP)
    fp32 = TM.init_params(tcfg, torch.Generator().manual_seed(5), "cpu")
    bf16 = TM.init_params(dataclasses.replace(tcfg, param_dtype="bfloat16"),
                          torch.Generator().manual_seed(5), "cpu")
    want = dict(tree_items(fp32))
    for k, t in tree_items(bf16):
        assert t.dtype == torch.bfloat16 and torch.equal(t, want[k].to(torch.bfloat16)), k
    assert bf16["blocks"]["moe"]["w_down"].shape == (2, 4, tcfg.moe_d_ff, tcfg.d_model)


def _one_stack_run_trunk(params, h, cfg, positions, caches=None, *, layer_range=None,
                         collect=()):
    """The trunk runner the two-stack one replaced (one stack, segmented
    at the collect layers and the hybrid sites), as it was."""
    from repro_torch.models.transformer import block_apply, layer_slice, run_stack, unstack

    (name, kind, n), = TM.trunk_layout(cfg)
    lo, hi = layer_range or (0, n)
    sites = TM.hybrid_sites(cfg)
    stops = sorted({hi, *(c for c in (*collect, *sites) if lo < c < hi)})
    collected, aux, start = {}, 0.0, lo
    layers = unstack(params[name], lo, hi)
    for stop in stops:
        h, a = run_stack(layers, h, cfg, kind, positions,
                         caches[name] if caches is not None else None, lo=start, hi=stop)
        aux = aux + a
        if stop in sites:
            site_cache = (layer_slice(caches["shared_attn"], sites.index(stop))
                          if caches is not None else None)
            h, _ = block_apply(params["shared_attn"], h, cfg, TM._SHARED_ATTN_KIND,
                               positions, site_cache)
        if stop in collect:
            collected[stop] = h
        start = stop
    return h, caches, aux, collected


@pytest.mark.parametrize("arch", ["phi3_mini_3_8b", "internvl2_76b", "qwen3_moe_30b_a3b",
                                  "mamba2_130m", "zamba2_1_2b"])
def test_one_stack_trunks_run_bitwise_as_before(arch):
    """Every one-stack trunk (dense, vlm, moe, ssm, and hybrid with its
    shared sites after layers 2 and 4) runs bitwise as under the one-stack
    runner the two-stack one replaced: a 6-token prefill over the whole
    trunk collecting after layers 1 and 3, then a decode step over layers
    2-4: hidden states, aux, collected states and every cache leaf equal
    (bf16)."""
    from repro_torch.configs import get_smoke_config

    kw = dict(num_layers=4, branch_layers=(1, 3))
    if arch == "zamba2_1_2b":
        kw["attn_every"] = 2
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    params = TM.compute_params(TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    g = torch.Generator().manual_seed(1)
    h0 = torch.randn((2, 6, cfg.d_model), generator=g).to(torch.bfloat16)
    h1 = torch.randn((2, 1, cfg.d_model), generator=g).to(torch.bfloat16)
    caches = [TM.init_caches(cfg, 2, 16, device="cpu") for _ in range(2)]
    runs = [TM.run_trunk, _one_stack_run_trunk]
    outs = [[run(params, h0, cfg, torch.arange(6), c, collect=(1, 3)),
             run(params, h1, cfg, torch.tensor([6]), c, layer_range=(1, 4), collect=(3,))]
            for run, c in zip(runs, caches)]
    for (h_a, _, aux_a, col_a), (h_b, _, aux_b, col_b) in zip(*outs):
        assert torch.equal(h_a, h_b)
        assert torch.equal(torch.as_tensor(aux_a), torch.as_tensor(aux_b))
        assert col_a.keys() == col_b.keys() and all(torch.equal(col_a[k], col_b[k])
                                                    for k in col_a)
    jax.tree.map(np.testing.assert_array_equal, bridge.caches_to_numpy(caches[0]),
                 bridge.caches_to_numpy(caches[1]))
