"""The port's serving path (``repro_torch.serving``) against the reference
``PartitionedServer`` on the CPU, on bridged weights.

Fixture: the ``phi3_mini_3_8b`` smoke config with ``num_layers=4,
branch_layers=(1, 3)`` split after layer 3 (the edge keeps branch 1; branch
3 sits at the cut and is discarded).

Cross-framework trajectories are compared in fp32 compute
(``dtype="float32"``), where the two frameworks' logits agree to ~1e-6:
tokens, exit masks, shipped rows, bytes and compaction buckets must then be
equal step after step.  In bf16 (the serving dtype) one bf16 ulp of
difference in a product can flip an argmax between two logits that round
to within an ulp of each other, so the bf16 comparison is one step from
identical inputs, exempting near-ties (a top-2 logit gap no larger than
twice the largest logit difference measured between the two) and
near-threshold rows (|H - thr| < 1e-3).
Invariants inside the port (compaction on/off, batched/per-head exits,
the overflow re-run) are exact in bf16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import model as JM
from repro.serving import PartitionedServer as JaxServer
from repro.serving import RequestScheduler as JaxScheduler
from repro.serving import TierExecutor as JaxExecutor
from repro.serving import segments_for_cuts as jax_segments
from repro_torch import bridge
from repro_torch.configs import ModelConfig
from repro_torch.models import model as TM
from repro_torch.serving import (
    PartitionedServer,
    RequestScheduler,
    TierExecutor,
    bytes_per_sequence,
    segments_for_cuts,
)

SPLIT = 3


def _cfgs(dtype, thr):
    jcfg = dataclasses.replace(get_smoke_config("phi3_mini_3_8b"), num_layers=4,
                               branch_layers=(1, 3), dtype=dtype,
                               exit_threshold=thr)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs("float32", 0.5)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _tokens(batch=8, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (batch, 1)).astype(np.int32)


@pytest.fixture(scope="module")
def mixed_threshold(weights):
    """Between the 4th and 5th smallest branch-1 entropies of the first
    step, so half the rows exit on the edge."""
    jp, _ = weights
    jcfg, _ = _cfgs("float32", 0.5)
    ex = JaxExecutor(jcfg, jp, jax_segments(jcfg, (SPLIT,)), use_kernels=False)
    res, _ = ex.step(jnp.asarray(_tokens()), 0, JM.init_caches(jcfg, 8, 32))
    e = np.sort(res.branch_entropy[1])
    return float((e[3] + e[4]) / 2)


def _threshold(value, mixed):
    return mixed if value == "mixed" else value


def _hops(rep):
    return [(c.survivors, c.bucket) for c in rep.compaction]


class TestPartitionedParity:
    @pytest.mark.parametrize("heads_batched", [True, False])
    @pytest.mark.parametrize("compaction", ["bucketed", "off"])
    @pytest.mark.parametrize("thr", [0.5, 1.5, "mixed"])
    def test_trajectory_matches_reference(self, weights, mixed_threshold, thr,
                                          compaction, heads_batched):
        jp, tp = weights
        jcfg, tcfg = _cfgs("float32", _threshold(thr, mixed_threshold))
        js = JaxServer(jcfg, jp, SPLIT, compaction=compaction,
                       heads_batched=heads_batched, use_kernels=False)
        ts = PartitionedServer(tcfg, tp, SPLIT, compaction=compaction,
                               heads_batched=heads_batched, device="cpu")
        jc, tc = JM.init_caches(jcfg, 8, 32), TM.init_caches(tcfg, 8, 32, device="cpu")
        jt = jnp.asarray(_tokens())
        tt = torch.from_numpy(_tokens())
        steps = 4
        for i in range(steps):
            jr, jc = js.step(jt, i, jc)
            tr, tc = ts.step(tt, i, tc)
            np.testing.assert_array_equal(tr.tokens, jr.tokens)
            np.testing.assert_array_equal(tr.exited_on_edge, jr.exited_on_edge)
            assert tr.shipped == jr.shipped
            assert tr.bytes_shipped == jr.bytes_shipped
            assert _hops(tr) == _hops(jr)
            assert tr.branch_take.keys() == jr.branch_take.keys()
            for layer in jr.branch_take:
                np.testing.assert_array_equal(tr.branch_take[layer], jr.branch_take[layer])
            jt = jr.tier_result.tokens_dev[:, None]
            tt = tr.tier_result.tokens_dev[:, None]
        assert tr.est_latency_s is None
        assert ts.executor.overflow_retries == js.executor.overflow_retries
        assert ts.executor.host_syncs == steps + ts.executor.overflow_retries

    def test_set_split_matches_reference(self, weights, mixed_threshold):
        jp, tp = weights
        jcfg, tcfg = _cfgs("float32", mixed_threshold)
        js = JaxServer(jcfg, jp, SPLIT, use_kernels=False)
        ts = PartitionedServer(tcfg, tp, SPLIT, device="cpu")
        jc, tc = JM.init_caches(jcfg, 8, 32), TM.init_caches(tcfg, 8, 32, device="cpu")
        jt, tt = jnp.asarray(_tokens()), torch.from_numpy(_tokens())
        for i, split in enumerate((SPLIT, SPLIT, 2, 2)):
            js.set_split(split)
            ts.set_split(split)
            jr, jc = js.step(jt, i, jc)
            tr, tc = ts.step(tt, i, tc)
            np.testing.assert_array_equal(tr.tokens, jr.tokens)
            np.testing.assert_array_equal(tr.exited_on_edge, jr.exited_on_edge)
            assert (tr.shipped, tr.bytes_shipped, _hops(tr)) == \
                (jr.shipped, jr.bytes_shipped, _hops(jr))
            jt = jr.tier_result.tokens_dev[:, None]
            tt = tr.tier_result.tokens_dev[:, None]

    def test_bf16_step_matches_reference_away_from_ties(self, weights, mixed_threshold):
        jp, tp = weights
        for thr in (0.5, mixed_threshold):
            jcfg, tcfg = _cfgs("bfloat16", thr)
            js = JaxServer(jcfg, jp, SPLIT, use_kernels=False)
            ts = PartitionedServer(tcfg, tp, SPLIT, device="cpu")
            jr, _ = js.step(jnp.asarray(_tokens()), 0, JM.init_caches(jcfg, 8, 32))
            tr, _ = ts.step(torch.from_numpy(_tokens()), 0, TM.init_caches(tcfg, 8, 32, device="cpu"))
            h = jr.tier_result.branch_entropy[1]
            clear = np.abs(h - thr) >= 1e-3
            np.testing.assert_array_equal(tr.exited_on_edge[clear], jr.exited_on_edge[clear])
            np.testing.assert_allclose(tr.tier_result.branch_entropy[1], h, rtol=0, atol=1e-3)
            jl = np.asarray(jr.tier_result.last_logits.astype(jnp.float32))
            dlog = np.abs(tr.tier_result.last_logits.float().numpy() - jl)
            top2 = np.sort(jl, -1)[:, -2:]
            live = ~jr.exited_on_edge
            assert dlog[live].max() <= 2.0 ** -5
            decided = live & (top2[:, 1] - top2[:, 0] > 2 * dlog[live].max())
            np.testing.assert_array_equal(tr.tokens[decided], jr.tokens[decided])
            assert decided.any()


class TestRequests:
    @pytest.mark.parametrize("reset_on_retire", [False, True])
    def test_submit_drain_matches_reference(self, weights, mixed_threshold,
                                            reset_on_retire):
        """Continuous batching over 4 slots: prompts of two lengths (one
        admission group padded with a sentinel row), budgets that retire
        requests at different steps, one request that stops at its first
        early exit, recycled slots; with ``reset_on_retire`` the retired
        rows' slot validity is cleared the same way on both sides."""
        jp, tp = weights
        jcfg, tcfg = _cfgs("float32", mixed_threshold)
        js = JaxServer(jcfg, jp, SPLIT, use_kernels=False)
        ts = PartitionedServer(tcfg, tp, SPLIT, device="cpu")
        jsched = JaxScheduler(js, 4, 32, reset_on_retire=reset_on_retire)
        tsched = RequestScheduler(ts, 4, 32, reset_on_retire=reset_on_retire)
        rng = np.random.default_rng(5)
        for plen, budget, stop in [(5, 3, False), (5, 5, True), (5, 2, False),
                                   (7, 4, False), (7, 3, False), (5, 2, False)]:
            prompt = rng.integers(0, 512, plen)
            assert jsched.submit(prompt, budget, stop_on_exit=stop) == \
                tsched.submit(prompt, budget, stop_on_exit=stop)
        jres, tres = jsched.drain(), tsched.drain()
        assert [r.rid for r in tres] == [r.rid for r in jres]
        for a, b in zip(tres, jres):
            assert a.tokens == b.tokens
            assert a.exited == b.exited
            assert a.exit_tiers == b.exit_tiers
            assert (a.slot, a.admitted_step, a.retired_step) == \
                (b.slot, b.admitted_step, b.retired_step)
        assert tsched.decode_steps == jsched.decode_steps
        ex = ts.executor
        assert ex.host_syncs == tsched.decode_steps + ex.overflow_retries
        np.testing.assert_array_equal(
            tsched.caches["blocks"]["self"]["pos"].numpy(),
            np.asarray(jsched.caches["blocks"]["self"]["pos"]))

    def test_server_request_api(self, weights):
        """``submit`` / ``run`` / ``drain`` on the server itself."""
        _, tp = weights
        _, tcfg = _cfgs("bfloat16", 0.5)
        ts = PartitionedServer(tcfg, tp, SPLIT, device="cpu", slots=2,
                               context_len=16)
        rids = [ts.submit(np.arange(4) + i, 3) for i in range(3)]
        reps = ts.run(max_steps=2)
        assert [len(r.emitted) for r in reps] == [2, 2]
        done = ts.drain()
        assert sorted(r.rid for r in done) == rids
        assert all(len(r.tokens) == 3 and r.ttft_s is not None for r in done)
        with pytest.raises(ValueError, match="context_len"):
            ts.submit(np.arange(14), 3)


class TestPortInvariants:
    """Exact inside the port, in bf16."""

    def _run(self, tp, thr, steps, stale_hint=False, **kw):
        _, tcfg = _cfgs("bfloat16", thr)
        ex = TierExecutor(tcfg, tp, segments_for_cuts(tcfg, (SPLIT,)), device="cpu", **kw)
        caches = TM.init_caches(tcfg, 8, 32, device="cpu")
        tok = torch.from_numpy(_tokens())
        out = []
        for i in range(steps):
            if stale_hint:
                ex._hints = {1: 1}  # forces an overflow re-run when > 1 survive
            res, caches = ex.step(tok, i, caches)
            out.append(res)
            tok = res.tokens_dev[:, None]
        return ex, out, caches

    def test_overflow_rerun_restores_caches_bitwise(self, weights, mixed_threshold):
        _, tp = weights
        exa, outa, ca = self._run(tp, mixed_threshold, 4)
        exb, outb, cb = self._run(tp, mixed_threshold, 4, stale_hint=True)
        assert exb.overflow_retries > exa.overflow_retries
        assert exb.host_syncs == 4 + exb.overflow_retries
        assert any(r.exited.any() for r in outa)
        for a, b in zip(outa, outb):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(a.exited, b.exited)
        for key in ("k", "v", "pos", "length"):
            assert torch.equal(ca["blocks"]["self"][key], cb["blocks"]["self"][key])
        assert torch.equal(ca["length"], cb["length"])

    def test_compaction_and_head_batching_are_invisible(self, weights, mixed_threshold):
        _, tp = weights
        _, base, _ = self._run(tp, mixed_threshold, 3)
        for kw in (dict(compaction="off"), dict(batched_heads=False)):
            _, other, _ = self._run(tp, mixed_threshold, 3, **kw)
            for a, b in zip(base, other):
                np.testing.assert_array_equal(a.tokens, b.tokens)
                np.testing.assert_array_equal(a.exited, b.exited)
                np.testing.assert_allclose(a.branch_entropy[1], b.branch_entropy[1],
                                           rtol=0, atol=1e-6)


class TestPlanningAndDevices:
    @pytest.mark.parametrize("cuts", [(), (1,), (2,), (3,), (4,), (1, 3), (2, 4)])
    def test_segments_match_reference(self, cuts):
        jcfg, tcfg = _cfgs("bfloat16", 0.5)
        got = [(s.layer_lo, s.layer_hi, s.branches, s.is_empty)
               for s in segments_for_cuts(tcfg, cuts)]
        want = [(s.layer_lo, s.layer_hi, s.branches, s.is_empty)
                for s in jax_segments(jcfg, cuts)]
        assert got == want
        assert bytes_per_sequence(tcfg, cuts[0] if cuts else 0) == \
            (4.0 if not cuts or cuts[0] == 0 else tcfg.d_model * 2.0)

    def test_no_device_without_cuda_raises(self, weights, monkeypatch):
        _, tp = weights
        _, tcfg = _cfgs("bfloat16", 0.5)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PartitionedServer(tcfg, tp, SPLIT)

    def test_use_kernels_true_on_cpu_raises(self, weights):
        _, tp = weights
        _, tcfg = _cfgs("bfloat16", 0.5)
        with pytest.raises(RuntimeError, match="sm_90"):
            PartitionedServer(tcfg, tp, SPLIT, device="cpu", use_kernels=True)
