"""The port's repartition controller and the scheduler features it rides
on, against the reference on the CPU, on bridged weights; and the two
example modules at smoke size.

  * the controller (reference ``tests/test_tiers.py`` TestRepartition,
    ``test_compaction.py`` TestDriftController, ``test_kernel_runtime.py``
    TestProbeSteps' controller cases): explicit ``update``, the drift
    trigger, ``update_network`` / ``update_tiers``, the bucketed 2-tier
    lattice solve and the exploration schedule — identical cuts after every
    trigger, p_k and KL within 1e-6;
  * the scheduler (reference ``tests/test_scheduler.py`` 298-590): gang
    admission, arrival steps, the active-mask snapshot, budget checks, the
    bucket hints across a retirement wave, the occupancy estimate and the
    sampled-probe accounting — counts and estimates equal to the
    reference's.

``test_tiers.py``'s pipelined-overlap solve and the uplinks that
``update_network`` installs are held in ``test_torch_link.py``, the fault
cases in ``test_torch_faults.py``; the ``update_network`` case here is held
to the reference's cut.

Fixture: the ``phi3_mini_3_8b`` smoke config with ``num_layers=4,
branch_layers=(1, 3)`` in fp32 compute, the threshold at the midpoint of
the first step's branch entropies, as in the reference tests.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import LayerCost as JLayerCost
from repro.core import NetworkProfile as JNetworkProfile
from repro.core import build_cost_profile as j_build_cost_profile
from repro.core.multitier import TierSpec as JTierSpec
from repro.models import model as JM
from repro.serving import MultiTierServer as JMultiTierServer
from repro.serving import PartitionedServer as JPartitionedServer
from repro.serving import RepartitionController as JController
from repro.serving import RequestScheduler as JScheduler
from repro.serving import ServingEngine as JServingEngine
from repro.serving import TierExecutor as JExecutor
from repro.serving import segments_for_cuts as jsegments
from repro.serving.controller import exit_distribution as j_exit_distribution
from repro.serving.controller import exit_drift_kl as j_exit_drift_kl
from repro_torch import bridge
from repro_torch.configs import ModelConfig
from repro_torch.core import (
    LayerCost,
    NetworkProfile,
    TierSpec,
    build_cost_profile,
    expected_time_multitier,
)
from repro_torch.examples import partition_sweep, quickstart
from repro_torch.models import model as TM
from repro_torch.serving import (
    MultiTierServer,
    PartitionedServer,
    RepartitionController,
    RequestScheduler,
    ServingEngine,
    exit_distribution,
    exit_drift_kl,
)
from repro_torch.serving.tiers import measured_exit_probs

B = 8
TOL = 1e-6


def _cfgs(thr=0.5):
    jcfg = dataclasses.replace(get_smoke_config("phi3_mini_3_8b"), num_layers=4,
                               branch_layers=(1, 3), dtype="float32",
                               exit_threshold=thr)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _toks(batch=B, seed=2):
    jcfg, _ = _cfgs()
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), (batch, 1), 0,
                                       jcfg.vocab_size))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def mixed(weights):
    """The midpoint of the K=1 step's branch entropies."""
    jp, _ = weights
    jcfg, _ = _cfgs()
    ex = JExecutor(jcfg, jp, jsegments(jcfg, ()), use_kernels=False)
    res, _ = ex.step(jnp.asarray(_toks()), 0, JM.init_caches(jcfg, B, 32))
    e = np.concatenate([res.branch_entropy[l] for l in jcfg.branch_layers])
    return float((e.min() + e.max()) / 2)


def _profiles(p_k, network="3g"):
    """The reference tests' synthetic profile: 1 ms layers, d * 2 bytes."""
    jcfg, tcfg = _cfgs()
    jprof = j_build_cost_profile(
        [JLayerCost(f"l{i}", 0, 0, jcfg.d_model * 2.0, 1e-3) for i in range(4)],
        jcfg.branch_layers, np.asarray(p_k), network, 50.0, 64.0)
    tprof = build_cost_profile(
        [LayerCost(f"l{i}", 0, 0, tcfg.d_model * 2.0, 1e-3) for i in range(4)],
        tcfg.branch_layers, np.asarray(p_k), network, 50.0, 64.0)
    return jprof, tprof


def _partitioned(weights, thr, split, p_k=None, **kw):
    jp, tp = weights
    jcfg, tcfg = _cfgs(thr)
    jkw, tkw = dict(kw), dict(kw)
    if p_k is not None:
        jkw["cost_profile"], tkw["cost_profile"] = _profiles(p_k)
    js = JPartitionedServer(jcfg, jp, split, use_kernels=False, **jkw)
    ts = PartitionedServer(tcfg, tp, split, device="cpu", **tkw)
    return js, ts


def _tiers(specs):
    return ([JTierSpec(*s) for s in specs], [TierSpec(*s) for s in specs])


def _stats(weights, thr, seed):
    """Both engines' exit stats over 3 steps of 4 prompts."""
    jp, tp = weights
    jcfg, tcfg = _cfgs(thr)
    prompts = np.array(jax.random.randint(jax.random.PRNGKey(seed), (4, 6), 0,
                                          jcfg.vocab_size))
    je = JServingEngine(jcfg, jp, context_len=64, use_kernels=False)
    te = ServingEngine(tcfg, tp, context_len=64, device="cpu")
    _, jstats = je.decode(je.start({"tokens": jnp.asarray(prompts)}), steps=3)
    _, tstats = te.decode(te.start({"tokens": prompts}), steps=3)
    np.testing.assert_array_equal(tstats.counts, jstats.counts)
    np.testing.assert_allclose(tstats.conditional_probs(), jstats.conditional_probs(),
                               rtol=0, atol=TOL)
    return jstats, tstats


class FakeReport:
    def __init__(self, batch, takes):
        self.tokens = np.zeros(batch, np.int64)
        self.branch_take = takes


class TestControllerTriggers:
    def test_update_closes_the_loop(self, weights, mixed):
        jstats, tstats = _stats(weights, mixed, 9)
        js, ts = _partitioned(weights, mixed, 0, p_k=tstats.conditional_probs())
        jc = JController(js, js.cost_profile)
        tc = RepartitionController(ts, ts.cost_profile)
        cuts = tc.update(tstats)
        assert cuts == jc.update(jstats) == (ts.split_layer,)
        np.testing.assert_allclose(tc._installed_p, jc._installed_p, rtol=0, atol=TOL)
        jr, _ = js.step(jnp.asarray(_toks(4)), 0, JM.init_caches(js.cfg, 4, 32))
        tr, _ = ts.step(torch.from_numpy(_toks(4)), 0,
                        TM.init_caches(ts.cfg, 4, 32, device="cpu"))
        np.testing.assert_array_equal(tr.tokens, jr.tokens)

    def test_update_multitier(self, weights, mixed):
        jstats, tstats = _stats(weights, mixed, 10)
        jprof, tprof = _profiles(tstats.conditional_probs())
        jt, tt = _tiers([("d", 50.0, 1e6), ("e", 10.0, 1e7), ("c", 1.0)])
        jp, tp = weights
        jcfg, tcfg = _cfgs(mixed)
        js = JMultiTierServer(jcfg, jp, jt, (0, 0), cost=(jprof.t_c, jprof.alpha),
                              use_kernels=False)
        ts = MultiTierServer(tcfg, tp, tt, (0, 0), cost=(tprof.t_c, tprof.alpha),
                             device="cpu")
        cuts = RepartitionController(ts, tprof, tt).update(tstats)
        assert cuts == JController(js, jprof, jt).update(jstats) == ts.cuts
        jr, _ = js.step(jnp.asarray(_toks(4)), 0, JM.init_caches(jcfg, 4, 32))
        tr, _ = ts.step(torch.from_numpy(_toks(4)), 0,
                        TM.init_caches(tcfg, 4, 32, device="cpu"))
        np.testing.assert_array_equal(tr.exit_tier, jr.exit_tier)
        assert tr.est_latency_s == pytest.approx(jr.est_latency_s, rel=1e-12)

    @pytest.mark.parametrize("p_k", [(0.6, 0.2), (0.1, 0.1), (0.9, 0.5)])
    def test_bucketed_two_tier_solves_the_lattice(self, weights, p_k):
        """With ``batch`` set and a compacting 2-tier server, solve() picks
        the cut minimizing the bucketed lattice cost, as the reference."""
        p_k = np.array(p_k)
        js, ts = _partitioned(weights, 0.5, 0, p_k=p_k)
        cut, = RepartitionController(ts, ts.cost_profile, batch=8).solve(p_k)
        assert (cut,) == JController(js, js.cost_profile, batch=8).solve(p_k)
        prof = ts.cost_profile
        tiers = [TierSpec("edge", prof.gamma, prof.network.bandwidth_bps),
                 TierSpec("cloud", 1.0)]
        best = min(range(5), key=lambda s: expected_time_multitier(
            prof.t_c, prof.alpha, prof.branch_exit_probs(), tiers, (s,), batch=8))
        assert cut == best

    def test_update_network_and_tiers(self, weights):
        js, ts = _partitioned(weights, 0.5, 0, p_k=(0.2, 0.2))
        jc = JController(js, js.cost_profile)
        tc = RepartitionController(ts, ts.cost_profile)
        assert tc._install(np.array([0.2, 0.2])) == jc._install(np.array([0.2, 0.2]))
        for name, bw in (("3g", 0.4e6), ("wifi", 18.8e6), ("3g", 1.1e6)):
            cuts = tc.update_network(NetworkProfile(name, bw))
            assert cuts == jc.update_network(JNetworkProfile(name, bw))
            assert ts.cost_profile.network.bandwidth_bps == bw
        with pytest.raises(TypeError, match="2-tier"):
            tc.update_tiers([])
        jp, tp = weights
        jcfg, tcfg = _cfgs()
        jprof, tprof = _profiles((0.2, 0.2))
        jt, tt = _tiers([("d", 50.0, 1e6), ("e", 10.0, 1e7), ("c", 1.0)])
        jm = JMultiTierServer(jcfg, jp, jt, (1, 2), use_kernels=False)
        tm = MultiTierServer(tcfg, tp, tt, (1, 2), device="cpu")
        jc = JController(jm, jprof, jt, batch=8)
        tc = RepartitionController(tm, tprof, tt, batch=8)
        jnew, tnew = _tiers([("d", 50.0, 5e5), ("e", 10.0, 5e6), ("c", 1.0)])
        assert tc.update_tiers(tnew) == jc.update_tiers(jnew) == tm.cuts
        assert tm.tiers[0].uplink_bps == 5e5
        with pytest.raises(TypeError, match="K>=3"):
            tc.update_network(NetworkProfile("3g", 1e6))


class TestDrift:
    def test_exit_distribution_and_kl(self):
        for p, q in (((0.3, 0.2), (0.3, 0.2)), ((0.9, 0.0), (0.0, 0.0)),
                     ((0.5, 0.7, 0.1), (0.2, 0.1, 0.9))):
            p, q = np.array(p), np.array(q)
            np.testing.assert_allclose(exit_distribution(p), j_exit_distribution(p),
                                       rtol=0, atol=1e-12)
            assert exit_drift_kl(p, q) == pytest.approx(j_exit_drift_kl(p, q),
                                                        abs=TOL)
        assert exit_drift_kl(np.array([0.3, 0.2]), np.array([0.3, 0.2])) == \
            pytest.approx(0.0, abs=1e-9)

    def test_observe_triggers_on_drift(self, weights):
        """Matching traffic keeps the plan; drifted traffic re-solves at
        the every-N check, then the window re-anchors; a forced update
        re-solves — step for step as the reference."""
        js, ts = _partitioned(weights, 0.5, 2, p_k=(0.1, 0.1))
        ctls = [cls(srv, srv.cost_profile, kl_threshold=0.05, every_n_steps=2)
                for cls, srv in ((JController, js), (RepartitionController, ts))]
        for c in ctls:
            c._install(np.array([0.1, 0.1]))
        b = 10
        match = {1: np.zeros(b, bool), 3: np.zeros(b, bool)}
        match[1][:1] = True
        match[3][1:2] = True
        drift = {1: np.ones(b, bool), 3: np.zeros(b, bool)}
        swapped = 0
        for takes in [match] * 2 + [drift] * 41:
            swaps = [c.observe(FakeReport(b, takes)) for c in ctls]
            assert swaps[1] == swaps[0]
            swapped += swaps[1] is not None
            assert ctls[1].drift_kl() == pytest.approx(ctls[0].drift_kl(), abs=TOL)
            np.testing.assert_allclose(ctls[1].measured_probs(),
                                       ctls[0].measured_probs(), rtol=0, atol=TOL)
        assert swapped >= 1 and ts.split_layer == js.split_layer
        assert ctls[1].drift_kl() < 0.05
        assert ctls[1].maybe_update(force=True) == ctls[0].maybe_update(force=True)

    def test_observe_counts_a_probed_early_branch(self, weights):
        """A probed branch before a kept one removes its would-exit rows
        from the alive mask: exits are intersected with it (the estimate
        stays <= 1)."""
        takes = {1: np.array([True, True, False, False]),
                 3: np.array([True, True, True, False])}
        for cls, srv in zip((JController, RepartitionController),
                            _partitioned(weights, 0.5, 2, p_k=(0.3, 0.3))):
            ctl = cls(srv, srv.cost_profile)
            ctl.observe(FakeReport(4, takes))
            np.testing.assert_allclose(ctl._arrivals, [4.0, 2.0])
            np.testing.assert_allclose(ctl._exits, [2.0, 1.0])
            np.testing.assert_allclose(ctl.measured_probs(), [0.5, 0.5])


class TestProbeEstimate:
    def test_probe_step_estimate_counts_live_rows_once(self, weights, mixed):
        """At split 1 a probe step reports would-exit masks of branch 1
        (at the cut, on the edge) and branch 3 (in the cloud), both under
        the plan's exits: they overlap.  The estimate's conditional p_k
        counts each branch over the rows still alive, so it stays a
        probability; a normal step's equals the reference's."""
        js, ts = _partitioned(weights, mixed, 1, p_k=(0.2, 0.2))
        jr, _ = js.step(jnp.asarray(_toks()), 0, JM.init_caches(js.cfg, B, 32))
        tr, _ = ts.step(torch.from_numpy(_toks()), 0,
                        TM.init_caches(ts.cfg, B, 32, device="cpu"))
        assert tr.est_latency_s == pytest.approx(jr.est_latency_s, rel=1e-12)
        ts.executor.probe_next = True
        tr, _ = ts.step(torch.from_numpy(_toks()), 0,
                        TM.init_caches(ts.cfg, B, 32, device="cpu"))
        take1, take3 = tr.branch_take[1], tr.branch_take[3]
        assert (take1 & take3).any()  # the masks overlap
        p = measured_exit_probs(tr.tier_result)
        assert p[1] == take1.mean()
        assert p[3] == (take3 & ~take1).sum() / (~take1).sum()
        assert np.isfinite(tr.est_latency_s)


class TestExploration:
    @pytest.mark.parametrize("explore", [2, 0])
    def test_probes_refresh_the_discarded_branch(self, weights, mixed, explore):
        """explore_every_n=2: the probed step gives branch 3 (discarded by
        the split-2 plan) measured arrivals; without exploration it keeps
        the installed estimate.  Counts equal the reference's."""
        js, ts = _partitioned(weights, mixed, 2, p_k=(0.3, 0.7))
        ctls = [cls(srv, srv.cost_profile, explore_every_n=explore)
                for cls, srv in ((JController, js), (RepartitionController, ts))]
        for c in ctls:
            c._installed_p = np.array([0.3, 0.7])
        jc, tc = JM.init_caches(js.cfg, B, 32), TM.init_caches(ts.cfg, B, 32,
                                                                device="cpu")
        jt, tt = jnp.asarray(_toks()), torch.from_numpy(_toks())
        for i in range(4):
            jr, jc = js.step(jt, i, jc)
            tr, tc = ts.step(tt, i, tc)
            assert sorted(tr.branch_take) == sorted(jr.branch_take)
            for c, rep in zip(ctls, (jr, tr)):
                c.observe(rep)
            np.testing.assert_array_equal(ctls[1]._arrivals, ctls[0]._arrivals)
            np.testing.assert_array_equal(ctls[1]._exits, ctls[0]._exits)
            jt, tt = jnp.asarray(jr.tokens[:, None]), tr.tokens[:, None]
        np.testing.assert_allclose(ctls[1].measured_probs(), ctls[0].measured_probs(),
                                   rtol=0, atol=TOL)
        if explore:
            assert ctls[1]._arrivals[1] > 0
            assert ctls[1].measured_probs()[1] != pytest.approx(0.7)
        else:
            assert ctls[1]._arrivals[1] == 0
            assert ctls[1].measured_probs()[1] == pytest.approx(0.7)

    def test_sampled_probe_accounting(self, weights, mixed):
        """Arrivals at a sampled probed branch count its covered rows
        only, as the reference counts them."""
        js, ts = _partitioned(weights, mixed, 2, p_k=(0.2, 0.2), slots=8)
        ctls = [cls(srv, srv.cost_profile, explore_every_n=2, probe_sample_frac=0.5)
                for cls, srv in ((JController, js), (RepartitionController, ts))]
        jc, tc = JM.init_caches(js.cfg, B, 32), TM.init_caches(ts.cfg, B, 32,
                                                                device="cpu")
        jt, tt = jnp.asarray(_toks()), torch.from_numpy(_toks())
        covered = 0
        for i in range(6):
            jr, jc = js.step(jt, i, jc)
            tr, tc = ts.step(tt, i, tc)
            res, jmask = tr.tier_result, jr.tier_result.branch_probe_mask
            assert sorted(res.branch_probe_mask) == sorted(jmask)
            for layer, cover in res.branch_probe_mask.items():
                np.testing.assert_array_equal(cover, jmask[layer])
                covered += int(cover.sum())
            ctls[0].observe(jr.tier_result)
            ctls[1].observe(res)
            jt, tt = jr.tier_result.tokens_dev[:, None], res.tokens_dev[:, None]
        assert covered > 0
        np.testing.assert_array_equal(ctls[1]._arrivals, ctls[0]._arrivals)
        assert ctls[1]._arrivals[1] <= covered
        probs = ctls[1].measured_probs()
        assert (probs >= 0).all() and (probs <= 1).all()
        with pytest.raises(ValueError, match="probe_sample_frac"):
            RepartitionController(ts, ts.cost_profile, probe_sample_frac=0.0)


def _target(seed=9, plen=6):
    return np.random.default_rng(seed).integers(0, 512, plen).astype(np.int32)


class TestScheduler:
    def test_gang_and_continuous_admission(self, weights):
        """Gang admission pins freed slots until the wave drains (two full
        waves of 8 steps); continuous admission takes fewer steps.  Step
        counts and every request's admission equal the reference's."""
        for policy in ("gang", "continuous"):
            js, ts = _partitioned(weights, 0.0, 2, slots=4, context_len=64)
            scheds = [JScheduler(js, 4, 64, policy=policy),
                      RequestScheduler(ts, 4, 64, policy=policy)]
            rng = np.random.default_rng(5)
            for i in range(8):
                p = rng.integers(0, 512, 4).astype(np.int32)
                for s in scheds:
                    s.submit(p, 2 if i % 2 else 8)
            for s in scheds:
                s.run()
            assert scheds[1].step_count == scheds[0].step_count
            assert scheds[1].total_tokens == 4 * (2 + 8)
            assert [(r.admitted_step, r.retired_step, r.slot)
                    for r in scheds[1].results.values()] == \
                [(r.admitted_step, r.retired_step, r.slot)
                 for r in scheds[0].results.values()]
            if policy == "gang":
                assert scheds[1].step_count == 16
        with pytest.raises(ValueError, match="policy"):
            RequestScheduler(ts, 4, 64, policy="fifo")

    def test_arrival_steps(self, weights):
        """A held arrival is admitted at its step; a held queue head
        blocks no later request that has arrived."""
        js, ts = _partitioned(weights, 0.5, 2, slots=2)
        for srv in (js, ts):
            srv.submit(_target(), 2, arrival_step=3)
            srv.submit(_target(1), 2, arrival_step=50)
            srv.submit(_target(2), 2)
            assert srv.scheduler.pending() == 3
            srv.drain()
        jr, tr = js.scheduler.results, ts.scheduler.results
        assert [tr[i].admitted_step for i in range(3)] == \
            [jr[i].admitted_step for i in range(3)]
        assert tr[0].admitted_step >= 3 and tr[1].admitted_step >= 50
        assert tr[2].admitted_step == 0
        assert tr[1].ttft_s < tr[1].latency_s + tr[2].latency_s
        assert ts.scheduler.step_count == js.scheduler.step_count
        assert ts.scheduler.pending() == 0 and ts.scheduler.occupancy == 0.0

    def test_result_mask_snapshot_and_budget_checks(self, weights):
        js, ts = _partitioned(weights, 0.5, 2, slots=2, context_len=16)
        active = np.array([True, True, False, True])
        res, _ = ts.executor.step(torch.from_numpy(_toks(4)), np.zeros(4, np.int32),
                                  TM.init_caches(ts.cfg, 4, 16, device="cpu"),
                                  active=active)
        active[0] = False
        assert res.active[0]
        with pytest.raises(ValueError, match="context_len"):
            ts.submit(_target(plen=10), 10)
        with pytest.raises(ValueError, match="max_new_tokens"):
            ts.submit(_target(plen=4), 0)

    def test_hints_track_a_retirement_wave(self, weights):
        """The cloud bucket shrinks to the live width after a retirement
        wave and recovers through a counted overflow re-run when the freed
        slots refill — bucket for bucket as the reference."""
        out = []
        for srv in _partitioned(weights, 0.0, 2, slots=8, context_len=64,
                                hint_window=1):
            sched = srv.scheduler
            for i in range(8):
                sched.submit(_target(i), 3 if i < 4 else 9)
            buckets, retries = [], []
            while sched.active.any() or sched.queue:
                rep = sched.step()
                if rep is None:
                    continue
                res = rep.server_report.tier_result
                buckets.append(res.compaction[0].bucket)
                retries.append(srv.executor.overflow_retries)
                assert rep.occupancy == rep.live / 8
                if rep.step == 6:
                    for j in range(4):
                        sched.submit(_target(20 + j), 3)
            out.append((buckets, retries))
        assert out[1] == out[0]
        buckets, retries = out[1]
        assert buckets[0] == 8 and 4 in buckets[3:6] and buckets[-1] == 8
        assert retries[-1] >= 1

    def test_occupancy_prices_and_tracks_the_live_width(self, weights):
        """est_latency_s prices the step's live width (half occupancy is
        never costlier), and the controller's decaying occupancy estimate
        (an on_step callback) equals the reference's."""
        ests = []
        for srv in _partitioned(weights, 0.0, 2, p_k=(0.0, 0.0), slots=4,
                                context_len=64):
            sched = srv.scheduler
            for p in (_target(1, 4), _target(2, 4)):
                sched.submit(p, 6)
            half = sched.step().server_report
            for p in (_target(3, 4), _target(4, 4)):
                sched.submit(p, 6)
            full = sched.step().server_report
            assert (half.live, full.live) == (2, 4)
            assert half.est_latency_s <= full.est_latency_s
            ests.append((half.est_latency_s, full.est_latency_s))
        np.testing.assert_allclose(ests[1], ests[0], rtol=1e-12)
        occ = []
        for cls, sched_cls, srv in zip(
                (JController, RepartitionController), (JScheduler, RequestScheduler),
                _partitioned(weights, 0.5, 2, p_k=(0.2, 0.2), slots=4, context_len=64)):
            ctl = cls(srv, srv.cost_profile, batch=4)
            sched = sched_cls(srv, 4, 64, on_step=[ctl.observe])
            sched.submit(_target(), 4)
            sched.run()
            assert 0 < ctl._occ_est <= 0.5
            occ.append((ctl._occ_est, ctl._solve_occupancy()))
            ctl.occupancy = 0.75
            assert ctl._solve_occupancy() == 0.75
        np.testing.assert_allclose(occ[1], occ[0], rtol=0, atol=TOL)


class TestExamples:
    def test_quickstart_on_the_cpu(self, capsys):
        out = quickstart.main(["--device", "cpu"])
        text = capsys.readouterr().out
        assert "partitioned decode:" in text and "under wifi" in text
        assert set(out["splits"]) == {"3g", "4g", "wifi"}
        assert 0 <= out["split"] <= 2 and 0 <= out["shipped"] <= 64
        assert out["host_syncs"] == 8
        assert ((out["p_k"] >= 0) & (out["p_k"] <= 1)).all()

    def test_partition_sweep_on_a_saved_profile(self, tmp_path, capsys):
        rows = [dict(name=f"layer{i}", flops=0.0, bytes_accessed=0.0,
                     output_bytes=float(4096 >> i), time_s=1e-4 * (i + 1))
                for i in range(8)]
        path = tmp_path / "profile.json"
        path.write_text(json.dumps(rows))
        out = partition_sweep.main(["--device", "cpu", "--profile", str(path)])
        text = capsys.readouterr().out
        assert "Fig. 4" in text and "Fig. 5" in text and "gamma=  1000" in text
        assert all(v for k, v in out["fig4"].items() if k.startswith("monotone"))
        for splits in out["fig5_splits_3g"].values():
            assert (np.diff(splits) <= 0).all()
