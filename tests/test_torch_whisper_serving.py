"""Whisper's served paths in the port against the reference package on the
CPU, on weights carried by ``repro_torch.bridge``: the K=1
``ServingEngine`` and a K=2 ``PartitionedServer`` step by step, the tier
runtime's handling of the read-only ``cross_kv`` (compacted buckets gather
the survivors' rows, an overflow re-run restores nothing of it, a step
makes one host sync), the bridge's round trip of the tuple leaf, the
analyze-mode decode profile, and the admission paths both packages refuse.

The smoke config is cut to 4 decoder layers with branches 1 and 3 (the
reference's smoke config has 2 layers and one branch); fp32 compute, so
that tokens, exits, bytes and buckets are exact and logits agree within
1e-4 (the model tolerance of ``test_torch_moe.py``).  Inside the port, in
bf16: compaction on == off (tokens and exits exact, logits 2^-5) and the
overflow re-run (bitwise).
Graphed == eager and the kernels need a card: ``chip_smoke.py``'s
``whisper_phase`` holds them at full width and depth.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as j_smoke
from repro.core import profiler as JP
from repro.models import model as JM
from repro.serving import PartitionedServer as JPartitionedServer
from repro.serving import RequestScheduler as JRequestScheduler
from repro.serving import ServingEngine as JServingEngine
from repro_torch import bridge
from repro_torch.configs import ModelConfig
from repro_torch.core import profiler as TP
from repro_torch.models import model as TM
from repro_torch.serving import (
    PartitionedServer,
    RequestScheduler,
    ServingEngine,
    TierExecutor,
    segments_for_cuts,
)

ARCH = "whisper_medium"
MODEL = dict(rtol=1e-4, atol=1e-4)
DEEP = dict(num_layers=4, branch_layers=(1, 3))
SPLIT = 2  # the edge runs layers 1-2 and decides branch 1; the cloud 3-4
B, PROMPT, CTX = 8, 5, 16


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these shapes are small, and the test run's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    jcfg = dataclasses.replace(j_smoke(ARCH), **{"dtype": "float32", "param_dtype": "float32",
                                                 **DEEP, **kw})
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(7), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _inputs(cfg, seed=0):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, cfg.vocab_size, (B, PROMPT)).astype(np.int32),
            "frame_embeds": r.standard_normal(
                (B, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)}


def _jprefill(jp, jcfg, nb):
    return jax.jit(JM.prefill, static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in nb.items()}, jcfg, JM.init_caches(jcfg, B, CTX))


def _tprefill(tp, tcfg, nb, dtype=None):
    return TM.prefill(TM.compute_params(tp, TM.compute_dtype(tcfg)),
                      torch.from_numpy(nb["tokens"]).long(), tcfg,
                      TM.init_caches(tcfg, B, CTX, dtype, "cpu"),
                      frame_embeds=torch.from_numpy(nb["frame_embeds"]))


@pytest.fixture(scope="module")
def compacting(weights):
    """The fp32 config at a threshold between the 6th and 7th smallest
    branch-1 entropies of the reference's first step (at the median the
    bucket ladder rounds 4 survivors up to 8 and no bucket compacts)."""
    jp, _ = weights
    jcfg, _ = _cfgs()
    nb = _inputs(jcfg)
    jl, jc = _jprefill(jp, jcfg, nb)
    probe = JPartitionedServer(jcfg, jp, SPLIT, use_kernels=False)
    tok = jnp.argmax(jl[:, 0], -1).astype(jnp.int32)[:, None]
    rep, _ = probe.step(tok, PROMPT, jc)
    e = np.sort(rep.tier_result.branch_entropy[1])
    return float((e[5] + e[6]) / 2)


def test_engine_start_and_steps_match_reference(weights, compacting):
    """The K=1 engine (branches 1 and 3 in one exit decision): ``start``
    on tokens and frame embeddings sets ``pos`` to the token count (the
    frames take no decoder position) and fills the cross K/V; then 5 steps
    on both engines: tokens and exits exact, logits and entropies 1e-4."""
    jp, tp = weights
    jcfg, tcfg = _cfgs(exit_threshold=compacting)
    nb = _inputs(jcfg)
    jeng = JServingEngine(jcfg, jp, context_len=CTX, use_kernels=False)
    teng = ServingEngine(tcfg, tp, context_len=CTX, device="cpu")
    jst = jeng.start({k: jnp.asarray(v) for k, v in nb.items()})
    tst = teng.start(nb)
    assert tst["pos"] == jst["pos"] == PROMPT
    assert tst["caches"]["cross_kv"][0].abs().sum() > 0
    np.testing.assert_allclose(tst["last_logits"].numpy(), np.asarray(jst["last_logits"]),
                               **MODEL)
    jt = jnp.argmax(jst["last_logits"], -1).astype(jnp.int32)[:, None]
    tt = tst["last_logits"].argmax(-1).to(torch.int32)[:, None]
    jc, tc, exits = jst["caches"], tst["caches"], 0
    for i in range(5):
        jr, jc = jeng.step(jt, PROMPT + i, jc)
        tr, tc = teng.step(tt, PROMPT + i, tc)
        np.testing.assert_array_equal(tr.tokens, np.asarray(jr.tokens))
        np.testing.assert_array_equal(tr.exited, np.asarray(jr.exited))
        for layer in jcfg.branch_layers:
            np.testing.assert_allclose(tr.branch_entropy[layer],
                                       np.asarray(jr.branch_entropy[layer]), **MODEL)
        np.testing.assert_allclose(tr.last_logits.numpy(), np.asarray(jr.last_logits),
                                   **MODEL)
        exits += int(tr.exited.sum())
        jt, tt = jr.tokens_dev[:, None], tr.tokens_dev[:, None]
    assert teng.host_syncs == 5
    assert 0 < exits < 5 * B


def test_partitioned_k2_compacts_as_the_reference(weights, compacting):
    """A K=2 ``PartitionedServer`` at split 2 (edge: layers 1-2, branch 1;
    cloud: layers 3-4, where branch 3 is not evaluated), prefilled with
    ``prefill``, then 6 steps of ``step`` on both packages (the scheduler
    refuses audio in both), ``hint_window=1`` so the cloud buckets follow
    the survivors and the compacted rows gather their cross K/V: tokens,
    edge exits, bytes and buckets exact, live rows' logits 1e-4, one host
    sync a step (plus one per overflow re-run)."""
    jp, tp = weights
    jcfg, tcfg = _cfgs(exit_threshold=compacting)
    nb = _inputs(jcfg)
    jl, jc = _jprefill(jp, jcfg, nb)
    _, tc = _tprefill(tp, tcfg, nb)
    js = JPartitionedServer(jcfg, jp, SPLIT, use_kernels=False, hint_window=1)
    ts = PartitionedServer(tcfg, tp, SPLIT, device="cpu", hint_window=1)
    assert ts.executor.segments[0].branches == (1,)
    tok = np.asarray(jnp.argmax(jl[:, 0], -1)).astype(np.int32)[:, None]
    jt, tt = jnp.asarray(tok), tok
    buckets, exits = set(), 0
    for i in range(6):
        jr, jc = js.step(jt, PROMPT + i, jc)
        tr, tc = ts.step(tt, PROMPT + i, tc)
        np.testing.assert_array_equal(tr.tokens, np.asarray(jr.tokens))
        np.testing.assert_array_equal(tr.exited_on_edge, np.asarray(jr.exited_on_edge))
        assert (tr.shipped, tr.bytes_shipped) == (jr.shipped, jr.bytes_shipped)
        live = ~tr.exited_on_edge
        np.testing.assert_allclose(tr.tier_result.last_logits.numpy()[live],
                                   np.asarray(jr.tier_result.last_logits)[live], **MODEL)
        got = [c.bucket for c in tr.tier_result.compaction]
        assert got == [c.bucket for c in jr.tier_result.compaction]
        buckets |= set(got)
        exits += int(tr.exited_on_edge.sum())
        jt, tt = jr.tier_result.tokens_dev[:, None], tr.tier_result.tokens_dev[:, None]
    ex = ts.executor
    assert ex.host_syncs == 6 + ex.overflow_retries
    assert 0 < exits < 6 * B and min(buckets) < B


def _steps(tcfg, tp, nb, steps, hints=None, **kw):
    """``steps`` lock-step decode steps of a K=2 executor at split 2 (bf16
    or the config's dtype) after a prefill; ``hints``: the cloud bucket
    planned before each step (1 forces an overflow re-run whenever more
    than one row survives)."""
    ex = TierExecutor(tcfg, tp, segments_for_cuts(tcfg, (SPLIT,)), device="cpu", **kw)
    logits, caches = _tprefill(tp, tcfg, nb)
    tok = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
    out = []
    for i in range(steps):
        if hints is not None:
            ex._hints = {1: hints[i]}
        res, caches = ex.step(tok, PROMPT + i, caches)
        out.append(res)
        tok = res.tokens_dev[:, None]
    return ex, out, caches


@pytest.fixture(scope="module")
def bf16_mixed(weights):
    """The bf16 config at a threshold between the 6th and 7th smallest
    first-step branch-1 entropies: most rows exit on the edge, so the
    cloud's bucket can shrink below the batch."""
    _, tp = weights
    _, tcfg = _cfgs(dtype="bfloat16")
    nb = _inputs(tcfg)
    _, out, _ = _steps(tcfg, tp, nb, 1)
    e = np.sort(out[0].branch_entropy[1])
    return dataclasses.replace(tcfg, exit_threshold=float((e[5] + e[6]) / 2)), nb


def test_compaction_on_equals_off(weights, bf16_mixed):
    """In bf16, compacted cloud buckets (the survivors' cross K/V rows
    gathered, sentinels clamped) against the masked full batch over 4
    steps: tokens, exits and the edge's entropies bitwise, the live rows'
    logits within 2^-5 (the port's bf16 model tolerance: a CPU bf16
    matmul over a narrower batch may sum in another order)."""
    _, tp = weights
    tcfg, nb = bf16_mixed
    exa, outa, _ = _steps(tcfg, tp, nb, 4, hint_window=1)
    _, outb, _ = _steps(tcfg, tp, nb, 4, compaction="off")
    assert min(c.bucket for r in outa for c in r.compaction) < B
    for a, b in zip(outa, outb):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.exited, b.exited)
        np.testing.assert_array_equal(a.branch_entropy[1], b.branch_entropy[1])
        live = ~a.exited
        np.testing.assert_allclose(a.last_logits[live].float().numpy(),
                                   b.last_logits[live].float().numpy(),
                                   rtol=2.0 ** -5, atol=2.0 ** -5)


def test_overflow_rerun_leaves_cross_kv_and_restores_rings(weights, bf16_mixed):
    """Forced overflow re-runs (cloud hint 1) restore the self-attention
    rings and counters; the cross K/V, which decode never writes, is not
    in the snapshot and stays bitwise as the prefill left it.  Trajectory
    and final caches bitwise those of a run planned with the buckets the
    re-runs used; host syncs = steps + re-runs."""
    _, tp = weights
    tcfg, nb = bf16_mixed
    exb, outb, cb = _steps(tcfg, tp, nb, 3, hints=[1, 1, 1])
    used = [r.compaction[0].bucket for r in outb]
    exa, outa, ca = _steps(tcfg, tp, nb, 3, hints=used)
    assert exa.overflow_retries == 0 < exb.overflow_retries
    assert exb.host_syncs == 3 + exb.overflow_retries
    rings, states = exb._stateful(cb)
    assert states == [] and len(rings) == 1 and "cross_kv" not in rings[0]
    saved, _ = exb._snapshot(cb, torch.tensor(PROMPT, dtype=torch.int32))
    assert [sorted(v) for _, _, v in saved] == [["k", "pos", "v"]]
    _, fresh = _tprefill(tp, tcfg, nb)
    for t, f in zip(cb["cross_kv"], fresh["cross_kv"]):
        assert torch.equal(t, f)
    for a, b in zip(outa, outb):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.exited, b.exited)
    jax.tree.map(np.testing.assert_array_equal, bridge.caches_to_numpy(ca),
                 bridge.caches_to_numpy(cb))


def test_bridge_round_trips_cross_kv(weights):
    """The reference's caches after an audio prefill (``cross_kv`` a
    tuple leaf beside the ring) through ``caches_from_jax`` and
    ``caches_to_numpy``: a tuple again, every leaf bitwise, fp32 and
    bf16; the port then decodes from the bridged caches as it does from
    its own prefill's (within 1e-4)."""
    jp, tp = weights
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = _cfgs(dtype=dtype)
        nb = _inputs(jcfg)
        jl, jc = _jprefill(jp, jcfg, nb)
        tc = bridge.caches_from_jax(jax.tree.map(np.array, jc), "cpu")
        assert isinstance(tc["cross_kv"], tuple)
        assert tc["cross_kv"][0].dtype == TM.compute_dtype(tcfg)
        back = bridge.caches_to_numpy(tc)
        want = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32))
                            if a.dtype == jnp.bfloat16 else np.asarray(a), jc)
        assert jax.tree.structure(back) == jax.tree.structure(want)
        jax.tree.map(np.testing.assert_array_equal, back, want)
    jcfg, tcfg = _cfgs()
    nb = _inputs(jcfg)
    jl, jc = _jprefill(jp, jcfg, nb)
    tc = bridge.caches_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    _, own = _tprefill(tp, tcfg, nb)
    tok = torch.from_numpy(np.array(jnp.argmax(jl[:, 0], -1))).long()[:, None]
    tpc = TM.compute_params(tp, torch.float32)
    a = TM.decode_step(tpc, tok, PROMPT, tc, tcfg)["logits"]
    b = TM.decode_step(tpc, tok, PROMPT, own, tcfg)["logits"]
    np.testing.assert_allclose(a.numpy(), b.numpy(), **MODEL)


def test_analyze_decode_profile_prices_cross_attention(weights):
    """``profile_decode_layers`` in analyze mode over the 4 decoder
    layers, whose caches carry the (zero) cross K/V as the reference's do:
    each layer's FLOPs within 5% of XLA's count of the reference's
    lowering, every layer alike, and above a layer priced without the
    cross-attention (the cross K/V left out of the caches)."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    b, c = 2, 16
    got = TP.profile_decode_layers(tcfg, tp, b, c, mode="analyze")
    xla = JP.profile_decode_layers(jcfg, jp, b, c, use_kernels=False, mode="analyze")
    assert [x.name for x in got] == [f"layer{i}" for i in range(1, 5)]
    for t, x in zip(got, xla):
        assert t.flops == pytest.approx(x.flops, rel=0.05)
        assert t.output_bytes == x.output_bytes == b * tcfg.d_model * 4
    assert len({t.flops for t in got}) == 1
    fns, inputs = TP.decode_layer_fns(tcfg, tp, b, c, use_kernels=False)
    h, caches = inputs[0]
    assert caches["cross_kv"][0].shape == (4, b, tcfg.encoder_seq_len, tcfg.num_kv_heads,
                                           tcfg.head_dim)
    no_cross = {k: v for k, v in caches.items() if k != "cross_kv"}
    bare = TP.analyze_layer_costs(fns[:1], [(h, no_cross)], TP.H100_SXM)
    # Cross-attention adds 2 x (q and out projections) + scores and
    # read-out over S_enc frames per row.
    d, s_enc = tcfg.d_model, tcfg.encoder_seq_len
    extra = b * (2 * 2 * d * d + 2 * 2 * s_enc * tcfg.q_dim)
    assert got[0].flops - bare[0].flops == pytest.approx(extra, rel=0.05)


def test_admission_paths_refuse_audio(weights):
    """As the reference: the request scheduler refuses an audio trunk
    (encoder states are per batch, not per slot) in both packages, and
    the port's row-targeted ``prefill_rows`` / ``reset_rows`` raise."""
    jp, tp = weights
    jcfg, tcfg = _cfgs()
    with pytest.raises(NotImplementedError):
        JRequestScheduler(JServingEngine(jcfg, jp, use_kernels=False), 4, CTX)
    with pytest.raises(NotImplementedError):
        RequestScheduler(ServingEngine(tcfg, tp, device="cpu"), 4, CTX)
    ex = TierExecutor(tcfg, tp, segments_for_cuts(tcfg, ()), device="cpu")
    caches = TM.init_caches(tcfg, 4, CTX, device="cpu")
    with pytest.raises(NotImplementedError, match="cross-KV"):
        ex.prefill_rows(caches, np.zeros((1, 3), np.int32), [0])
    with pytest.raises(NotImplementedError, match="cross-KV"):
        ex.reset_rows(caches, [0])
