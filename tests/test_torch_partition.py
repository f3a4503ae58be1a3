"""The port's partitioned serving stack — the K=1 calibration engine, the
K=2 ``PartitionedServer`` estimate and the K>=3 ``MultiTierServer`` —
against the reference package on the CPU, step by step, on bridged
weights.

Fixture: the ``phi3_mini_3_8b`` smoke config with ``num_layers=4,
branch_layers=(1, 3)`` in fp32 compute, where the two frameworks' logits
agree to ~1e-6: tokens, exit masks, exit counts, shipped rows, bytes and
compaction buckets must be equal, and ``est_latency_s`` (numpy on both
sides, from the same counts) equal to rtol 1e-12.  The mixed threshold
sits between the 4th and 5th branch-1 entropies of the engine's first
step, so rows exit at both branches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import LayerCost as JLayerCost
from repro.core import build_cost_profile as j_build_cost_profile
from repro.core.multitier import TierSpec as JTierSpec
from repro.core.multitier import expected_time_multitier as j_expected_time_multitier
from repro.core.profiler import HardwareSpec as JHardwareSpec
from repro.core.profiler import branch_head_cost as j_branch_head_cost
from repro.models import model as JM
from repro.serving import MultiTierServer as JMultiTierServer
from repro.serving import PartitionedServer as JPartitionedServer
from repro.serving import RequestScheduler as JScheduler
from repro.serving import ServingEngine as JServingEngine
from repro_torch import bridge
from repro_torch.configs import ModelConfig
from repro_torch.core import LayerCost, TierSpec, build_cost_profile
from repro_torch.models import model as TM
from repro_torch.serving import (
    MultiTierServer,
    PartitionedServer,
    RequestScheduler,
    ServingEngine,
    bytes_per_sequence,
)

BATCH, PROMPT, CONTEXT = 8, 5, 32
RTOL = 1e-12
TIERS = (("device", 60.0, 18.8e6), ("edge", 12.0, 1.10e6), ("cloud", 1.0))


def _cfgs(thr):
    jcfg = dataclasses.replace(get_smoke_config("phi3_mini_3_8b"), num_layers=4,
                               branch_layers=(1, 3), dtype="float32",
                               exit_threshold=thr)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs(0.5)
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _prompts():
    return np.random.default_rng(1).integers(0, 512, (BATCH, PROMPT)).astype(np.int32)


@pytest.fixture(scope="module")
def jservers():
    """Reference servers kept for reuse within this file.  A reference
    server jits its segments on its first steps, which is most of this
    file's time; a later test reuses one only where what it compares does
    not depend on the server's history (its host-sync count, bucket hints
    and overflow re-runs)."""
    return {}


@pytest.fixture(scope="module")
def mixed(weights, jservers):
    jp, _ = weights
    jcfg, _ = _cfgs(0.5)
    eng = jservers["engine", 0.5] = JServingEngine(jcfg, jp, context_len=CONTEXT,
                                                   use_kernels=False)
    _, stats = eng.decode(eng.start({"tokens": jnp.asarray(_prompts())}), 1)
    e = np.sort(stats.entropies[0][0])
    return float((e[3] + e[4]) / 2)


def _thr(value, mixed):
    return mixed if value == "mixed" else value


def _costs(cls, cfg):
    """Per-layer costs in the shape the profiler gives (alpha = B d 4)."""
    return [cls(f"layer{i}", 0.0, 0.0, BATCH * cfg.d_model * 4.0, 1e-3 * (1 + i))
            for i in range(1, cfg.num_layers + 1)]


def _profiles(jcfg, tcfg, p, network="4g"):
    jprof = j_build_cost_profile(_costs(JLayerCost, jcfg), jcfg.branch_layers, p,
                                 network, 25.0, 32 * 1024.0)
    tprof = build_cost_profile(_costs(LayerCost, tcfg), tcfg.branch_layers, p,
                               network, 25.0, 32 * 1024.0)
    return jprof, tprof


def _hops(rep):
    return [(c.survivors, c.bucket) for c in rep.compaction]


class TestServingEngine:
    @pytest.mark.parametrize("thr", [0.5, 1.5, "mixed"])
    def test_decode_and_calibration_match_reference(self, weights, mixed, jservers,
                                                    thr):
        jp, tp = weights
        jcfg, tcfg = _cfgs(_thr(thr, mixed))
        je = jservers.get(("engine", thr)) or JServingEngine(
            jcfg, jp, context_len=CONTEXT, use_kernels=False)
        syncs0 = je.host_syncs
        te = ServingEngine(tcfg, tp, context_len=CONTEXT, device="cpu")
        assert [s.branches for s in te.executor.segments] == [(1, 3)]
        jstate = je.start({"tokens": jnp.asarray(_prompts())})
        tstate = te.start({"tokens": _prompts()})
        assert tstate["pos"] == jstate["pos"] == PROMPT
        steps, counts = 0, 0
        for n in (1, 3):  # two decode calls continue one state
            jtok, jstats = je.decode(jstate, n)
            ttok, tstats = te.decode(tstate, n)
            steps += n
            counts = counts + tstats.counts
            np.testing.assert_array_equal(ttok, jtok)
            np.testing.assert_array_equal(tstats.counts, jstats.counts)
            np.testing.assert_array_equal(tstats.exit_fractions(),
                                          jstats.exit_fractions())
            np.testing.assert_array_equal(tstats.conditional_probs(),
                                          jstats.conditional_probs())
            for a, b in zip(tstats.entropies, jstats.entropies):
                np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
            cal_t = tstats.calibrate(tcfg.exit_threshold)
            cal_j = jstats.calibrate(jcfg.exit_threshold)
            for f in ("conditional_p", "unconditional_p", "exit_fraction"):
                np.testing.assert_array_equal(getattr(cal_t, f), getattr(cal_j, f))
        assert tstate["pos"] == jstate["pos"] == PROMPT + steps
        assert te.host_syncs == je.host_syncs - syncs0 == steps
        if thr == "mixed":
            assert (counts > 0).all()  # exits at both branches and the head

    def test_engine_serves_requests(self, weights, mixed):
        """K=1 through ``submit`` / ``drain``, request by request equal."""
        jp, tp = weights
        jcfg, tcfg = _cfgs(mixed)
        js = JScheduler(JServingEngine(jcfg, jp, use_kernels=False), 4, CONTEXT)
        ts = ServingEngine(tcfg, tp, device="cpu", slots=4, context_len=CONTEXT)
        rng = np.random.default_rng(5)
        for plen, budget in [(5, 3), (5, 4), (7, 2), (5, 3), (7, 3)]:
            prompt = rng.integers(0, 512, plen)
            assert js.submit(prompt, budget) == ts.submit(prompt, budget)
        for a, b in zip(ts.drain(), js.drain()):
            assert (a.rid, a.tokens, a.exited, a.exit_tiers) == \
                (b.rid, b.tokens, b.exited, b.exit_tiers)


class TestPartitionedEstimate:
    @pytest.mark.parametrize("compaction", ["bucketed", "off"])
    @pytest.mark.parametrize("split", [0, 2, 3, 4])
    def test_lockstep_estimate_matches_reference(self, weights, mixed, jservers,
                                                 split, compaction):
        jp, tp = weights
        jcfg, tcfg = _cfgs(mixed)
        jprof, tprof = _profiles(jcfg, tcfg, [0.4, 0.3])
        js = jservers["partitioned", split, compaction] = JPartitionedServer(
            jcfg, jp, split, cost_profile=jprof, compaction=compaction,
            use_kernels=False)
        ts = PartitionedServer(tcfg, tp, split, cost_profile=tprof,
                               compaction=compaction, device="cpu")
        jc = JM.init_caches(jcfg, BATCH, CONTEXT)
        tc = TM.init_caches(tcfg, BATCH, CONTEXT, device="cpu")
        jt = jnp.asarray(_prompts()[:, :1])
        tt = torch.from_numpy(_prompts()[:, :1])
        for i in range(3):
            jr, jc = js.step(jt, i, jc)
            tr, tc = ts.step(tt, i, tc)
            np.testing.assert_array_equal(tr.tokens, jr.tokens)
            np.testing.assert_array_equal(tr.exited_on_edge, jr.exited_on_edge)
            assert (tr.shipped, tr.bytes_shipped, _hops(tr)) == \
                (jr.shipped, jr.bytes_shipped, _hops(jr))
            assert tr.bytes_shipped == tr.shipped * bytes_per_sequence(tcfg, split) \
                or split == tcfg.num_layers
            assert np.isfinite(tr.est_latency_s)
            assert tr.est_latency_s == pytest.approx(jr.est_latency_s, rel=RTOL)
            jt = jr.tier_result.tokens_dev[:, None]
            tt = tr.tier_result.tokens_dev[:, None]

    def test_set_split_follows_the_plan(self, weights, mixed, jservers):
        """``cost_profile`` and ``set_split`` swapped at run time, as a
        repartitioning deployment does, with the estimate following.  The
        reference side is a server per split (tokens and the estimate do
        not depend on a server's history)."""
        jp, tp = weights
        jcfg, tcfg = _cfgs(mixed)
        ts = PartitionedServer(tcfg, tp, 0, device="cpu")
        jc = JM.init_caches(jcfg, BATCH, CONTEXT)
        tc = TM.init_caches(tcfg, BATCH, CONTEXT, device="cpu")
        jt, tt = jnp.asarray(_prompts()[:, :1]), torch.from_numpy(_prompts()[:, :1])
        for i, (network, split) in enumerate([("wifi", 3), ("3g", 4), ("4g", 2)]):
            js = jservers.get(("partitioned", split, "bucketed")) or \
                JPartitionedServer(jcfg, jp, split, use_kernels=False)
            js.cost_profile, ts.cost_profile = _profiles(jcfg, tcfg, [0.5, 0.2],
                                                         network)
            ts.set_split(split)
            jr, jc = js.step(jt, i, jc)
            tr, tc = ts.step(tt, i, tc)
            np.testing.assert_array_equal(tr.tokens, jr.tokens)
            assert tr.est_latency_s == pytest.approx(jr.est_latency_s, rel=RTOL)
            jt = jr.tier_result.tokens_dev[:, None]
            tt = tr.tier_result.tokens_dev[:, None]

    @pytest.mark.parametrize("compaction", ["bucketed", "off"])
    def test_submit_drain_estimate_matches_reference(self, weights, mixed,
                                                     compaction):
        """Continuous batching: steps with live < batch price the live
        width (occupancy) on both sides."""
        jp, tp = weights
        jcfg, tcfg = _cfgs(mixed)
        jprof, tprof = _profiles(jcfg, tcfg, [0.4, 0.3])
        js = JScheduler(JPartitionedServer(jcfg, jp, 3, cost_profile=jprof,
                                           compaction=compaction,
                                           use_kernels=False), 4, CONTEXT)
        ts = RequestScheduler(PartitionedServer(tcfg, tp, 3, cost_profile=tprof,
                                                compaction=compaction,
                                                device="cpu"), 4, CONTEXT)
        rng = np.random.default_rng(7)
        for plen, budget in [(5, 2), (5, 5), (7, 3), (5, 1), (7, 4)]:
            prompt = rng.integers(0, 512, plen)
            assert js.submit(prompt, budget) == ts.submit(prompt, budget)
        jreps, treps = js.run(), ts.run()
        assert len(treps) == len(jreps)
        assert any(r.live < 4 for r in treps)
        for a, b in zip(treps, jreps):
            assert a.live == b.live and a.emitted == b.emitted
            assert a.server_report.live == b.server_report.live
            assert a.server_report.est_latency_s == pytest.approx(
                b.server_report.est_latency_s, rel=RTOL)

    @pytest.mark.parametrize("heads_batched", [True, False])
    def test_priced_heads_match_reference_cost_on_h100(self, weights, mixed,
                                                       heads_batched):
        """``price_heads`` prices the exit heads on H100_SXM; the reference
        server prices them on its TPU spec, so the port is held against the
        reference's ``expected_time_multitier`` with its ``branch_head_cost``
        on a ``HardwareSpec`` of the H100 values and this step's measured
        exit probabilities."""
        jp, tp = weights
        jcfg, tcfg = _cfgs(mixed)
        jprof, tprof = _profiles(jcfg, tcfg, [0.4, 0.3])
        split = 3
        ts = PartitionedServer(tcfg, tp, split, cost_profile=tprof, price_heads=True,
                               heads_batched=heads_batched, device="cpu")
        plain = PartitionedServer(tcfg, tp, split, cost_profile=tprof, device="cpu")
        h100 = JHardwareSpec("h100", peak_flops=989e12, hbm_bw=3.35e12,
                             link_bw=450e9, hbm_bytes=80e9)
        tc = TM.init_caches(tcfg, BATCH, CONTEXT, device="cpu")
        pc = TM.init_caches(tcfg, BATCH, CONTEXT, device="cpu")
        tt = torch.from_numpy(_prompts()[:, :1])
        for i in range(3):
            tr, tc = ts.step(tt, i, tc)
            pr, pc = plain.step(tt, i, pc)
            p = np.zeros(tcfg.num_layers + 1)
            alive = float(BATCH)
            for layer in sorted(tr.branch_take):
                took = float(tr.branch_take[layer].sum())
                p[layer] = took / alive
                alive -= took
            want = j_expected_time_multitier(
                jprof.t_c, jprof.alpha, p,
                [JTierSpec("edge", 25.0, jprof.network.bandwidth_bps),
                 JTierSpec("cloud", 1.0)], (split,), batch=BATCH, occupancy=1.0,
                head_cost=j_branch_head_cost(jcfg, BATCH, heads_batched=heads_batched,
                                             hardware=h100),
                branch_layers=jcfg.branch_layers)
            assert tr.est_latency_s == pytest.approx(want, rel=RTOL)
            assert tr.est_latency_s > pr.est_latency_s
            tt = tr.tier_result.tokens_dev[:, None]

    def test_no_profile_no_estimate(self, weights):
        _, tp = weights
        _, tcfg = _cfgs(0.5)
        ts = PartitionedServer(tcfg, tp, 2, device="cpu")
        rep, _ = ts.step(torch.from_numpy(_prompts()[:, :1]), 0,
                         TM.init_caches(tcfg, BATCH, CONTEXT, device="cpu"))
        assert rep.est_latency_s is None


def _tiers():
    return ([JTierSpec(*t) for t in TIERS], [TierSpec(*t) for t in TIERS])


class TestMultiTierServer:
    @pytest.mark.parametrize("thr", ["mixed", 1.5])
    @pytest.mark.parametrize("compaction", ["bucketed", "off"])
    @pytest.mark.parametrize("cuts", [(1, 3), (0, 2)])
    def test_steps_match_reference(self, weights, mixed, cuts, compaction, thr):
        jp, tp = weights
        jcfg, tcfg = _cfgs(_thr(thr, mixed))
        jprof, tprof = _profiles(jcfg, tcfg, [0.4, 0.3], "3g")
        jtiers, ttiers = _tiers()
        js = JMultiTierServer(jcfg, jp, jtiers, cuts, cost=(jprof.t_c, jprof.alpha),
                              compaction=compaction, use_kernels=False)
        ts = MultiTierServer(tcfg, tp, ttiers, cuts, cost=(tprof.t_c, tprof.alpha),
                             compaction=compaction, device="cpu")
        jc = JM.init_caches(jcfg, BATCH, CONTEXT)
        tc = TM.init_caches(tcfg, BATCH, CONTEXT, device="cpu")
        jt = jnp.asarray(_prompts()[:, :1])
        tt = torch.from_numpy(_prompts()[:, :1])
        for i in range(4):
            jr, jc = js.step(jt, i, jc)
            tr, tc = ts.step(tt, i, tc)
            np.testing.assert_array_equal(tr.tokens, jr.tokens)
            np.testing.assert_array_equal(tr.exit_tier, jr.exit_tier)
            np.testing.assert_array_equal(tr.exited, jr.exited)
            assert tr.shipped_per_hop == jr.shipped_per_hop
            assert tr.bytes_per_hop == jr.bytes_per_hop
            assert tr.transfer_s_per_hop == jr.transfer_s_per_hop
            assert _hops(tr) == _hops(jr)
            for j, cut in enumerate(cuts):
                assert tr.bytes_per_hop[j] == \
                    tr.shipped_per_hop[j] * bytes_per_sequence(tcfg, cut)
            assert tr.est_latency_s == pytest.approx(jr.est_latency_s, rel=RTOL)
            jt = jr.tier_result.tokens_dev[:, None]
            tt = tr.tier_result.tokens_dev[:, None]
        assert ts.executor.overflow_retries == js.executor.overflow_retries
        assert ts.executor.host_syncs == 4 + ts.executor.overflow_retries

    def test_from_plan_install_cuts_and_requests(self, weights, mixed):
        """A solved plan installed, hot-swapped and served through
        ``submit`` / ``drain`` on both sides."""
        from repro.core.multitier import solve_multitier as j_solve
        from repro_torch.core import solve_multitier

        jp, tp = weights
        jcfg, tcfg = _cfgs(mixed)
        jprof, tprof = _profiles(jcfg, tcfg, [0.4, 0.3], "3g")
        jtiers, ttiers = _tiers()
        jplan = j_solve(jprof.t_c, jprof.alpha, jprof.branch_exit_probs(), jtiers)
        tplan = solve_multitier(tprof.t_c, tprof.alpha, tprof.branch_exit_probs(),
                                ttiers)
        assert dataclasses.astuple(tplan) == dataclasses.astuple(jplan)
        ts = MultiTierServer.from_plan(tcfg, tp, tplan, ttiers,
                                       cost=(tprof.t_c, tprof.alpha), device="cpu",
                                       slots=4, context_len=CONTEXT)
        assert ts.cuts == tplan.cut_after
        with pytest.raises(ValueError, match="cuts"):
            ts.install_cuts((1,))
        js = JMultiTierServer(jcfg, jp, jtiers, (0, 2), cost=(jprof.t_c, jprof.alpha),
                              use_kernels=False, slots=4, context_len=CONTEXT)
        ts.install_cuts((0, 2))
        rng = np.random.default_rng(9)
        for plen, budget in [(5, 3), (7, 4), (5, 2), (5, 3), (7, 2)]:
            prompt = rng.integers(0, 512, plen)
            assert js.submit(prompt, budget) == ts.submit(prompt, budget)
        jreps, treps = js.run(), ts.run()
        assert len(treps) == len(jreps)
        for a, b in zip(treps, jreps):
            ra, rb = a.server_report, b.server_report
            assert a.emitted == b.emitted
            np.testing.assert_array_equal(ra.exit_tier[ra.tier_result.active],
                                          rb.exit_tier[rb.tier_result.active])
            assert (ra.shipped_per_hop, ra.bytes_per_hop, _hops(ra)) == \
                (rb.shipped_per_hop, rb.bytes_per_hop, _hops(rb))
            assert ra.est_latency_s == pytest.approx(rb.est_latency_s, rel=RTOL)
