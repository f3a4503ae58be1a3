"""The port's link simulation and pipelined overlap against the reference
on the CPU, on bridged weights (reference ``tests/test_tiers.py``
TestPipelinedRuntime and the overlap solve, ``test_compaction.py``
TestSimulatedNetwork and TestPipelinedCompaction).

  * ``simulate_network``: per-hop bytes and simulated transfer seconds
    equal to the reference's step by step (K=2 from ``network``, K=3 from
    each ``TierSpec.uplink_bps``), as are tokens, masks and the estimates,
    serial and pipelined (the lattice's overlap cost); a step's wall time
    pays its transfer;
  * a dead uplink with bytes queued raises ``LinkDownError`` (no fault
    model) instead of sleeping 0 s;
  * ``overlap="pipelined"`` reorders only the simulated sleeps: tokens,
    masks, bytes and ``sim_transfer_s`` bitwise those of serial mode, one
    sync per step; ``drain``; a forced overflow re-run drains and pays
    serially (``pipeline_fallbacks``); on a host clock that only sleeps
    move, the steady step is the slowest hop instead of the serial sum;
  * the controller re-solves a pipelined server against the bottleneck
    stage, and ``update_network`` carries the new uplink into the
    segments, as in the reference.

Uplinks are chosen so that each sleep is a few ms.  Fixture: the
``phi3_mini_3_8b`` smoke config with ``num_layers=4, branch_layers=(1,
3)`` in fp32 compute, the threshold at the midpoint of the first step's
branch entropies, as in the reference tests.
"""

import dataclasses
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.core import LayerCost as JLayerCost
from repro.core import NetworkProfile as JNetworkProfile
from repro.core import build_cost_profile as j_build_cost_profile
from repro.core.multitier import TierSpec as JTierSpec
from repro.models import model as JM
from repro.serving import MultiTierServer as JMultiTierServer
from repro.serving import PartitionedServer as JPartitionedServer
from repro.serving import RepartitionController as JController
from repro.serving import TierExecutor as JExecutor
from repro.serving import segments_for_cuts as jsegments
from repro_torch import bridge
from repro_torch.configs import ModelConfig
from repro_torch.core import (
    LayerCost,
    NetworkProfile,
    TierSpec,
    build_cost_profile,
    expected_time_multitier,
)
from repro_torch.models import model as TM
from repro_torch.serving import tiers as tiers_mod
from repro_torch.serving import (
    LinkDownError,
    LinkFaultModel,
    MultiTierServer,
    PartitionedServer,
    RepartitionController,
    TierExecutor,
    segments_for_cuts,
)

B = 8
PER_SEQ = 256 * 2.0  # bf16 residual of the smoke trunk's d_model


def _cfgs(thr=0.5):
    jcfg = dataclasses.replace(get_smoke_config("phi3_mini_3_8b"), num_layers=4,
                               branch_layers=(1, 3), dtype="float32",
                               exit_threshold=thr)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _toks(cfg, batch=B):
    return np.array(jax.random.randint(jax.random.PRNGKey(2), (batch, 1), 0,
                                       cfg.vocab_size))


@pytest.fixture(scope="module")
def deep_model():
    jcfg, _ = _cfgs()
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    ex = JExecutor(jcfg, jp, jsegments(jcfg, ()), use_kernels=False)
    res, _ = ex.step(jnp.asarray(_toks(jcfg)), 0, JM.init_caches(jcfg, B, 32))
    ents = np.concatenate([res.branch_entropy[l] for l in jcfg.branch_layers])
    return jp, tp, float((ents.min() + ents.max()) / 2)


def _profiles(cfg_pair, p_k=(0.2, 0.2), network="3g"):
    out = []
    for cost, build, cfg in zip((JLayerCost, LayerCost),
                                (j_build_cost_profile, build_cost_profile), cfg_pair):
        costs = [cost(f"l{i}", 0, 0, cfg.d_model * 2.0, 1e-3)
                 for i in range(cfg.num_layers)]
        out.append(build(costs, cfg.branch_layers, np.array(p_k), network, 50.0, 64.0))
    return out


def _drive(srv, caches, tok, steps):
    """``steps`` lock-step steps; returns the reports."""
    reps = []
    for i in range(steps):
        rep, caches = srv.step(tok, i, caches)
        reps.append(rep)
        tok = rep.tier_result.tokens_dev[:, None]
    srv.executor.drain()
    return reps


def _same_reports(t_reps, j_reps, hops=1):
    for t, j in zip(t_reps, j_reps):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        tr, jr = t.tier_result, j.tier_result
        np.testing.assert_array_equal(tr.exited, np.asarray(jr.exited))
        np.testing.assert_array_equal(tr.exit_tier, jr.exit_tier)
        assert tr.shipped_per_hop == jr.shipped_per_hop
        assert tr.bytes_per_hop == jr.bytes_per_hop
        assert t.sim_transfer_s == j.sim_transfer_s and len(t.sim_transfer_s) == hops
        assert t.pipeline_fallbacks == j.pipeline_fallbacks
        assert [(c.survivors, c.bucket) for c in tr.compaction] == \
            [(c.survivors, c.bucket) for c in jr.compaction]
        assert t.est_latency_s == pytest.approx(j.est_latency_s, rel=1e-6)


class TestSimulatedNetwork:
    @pytest.mark.parametrize("overlap", ["serial", "pipelined"])
    def test_two_tier_equals_the_reference(self, deep_model, overlap):
        """K=2 at split 2 over a link that ships the batch in ~3 ms: bytes,
        sim seconds, tokens, buckets and est_latency_s (the lattice's
        bottleneck-stage cost when pipelined) equal the reference's."""
        jp, tp, thr = deep_model
        jcfg, tcfg = _cfgs(thr)
        bw = PER_SEQ * B * 8.0 / 0.003
        jprof, tprof = _profiles((jcfg, tcfg))
        js = JPartitionedServer(jcfg, jp, 2, network=JNetworkProfile("slow", bw),
                                cost_profile=jprof, simulate_network=True,
                                overlap=overlap, use_kernels=False)
        ts = PartitionedServer(tcfg, tp, 2, network=NetworkProfile("slow", bw),
                               cost_profile=tprof, simulate_network=True,
                               overlap=overlap, device="cpu")
        assert ts.executor.segments[0].uplink_bps == bw
        j_reps = _drive(js, JM.init_caches(jcfg, B, 32), jnp.asarray(_toks(jcfg)), 4)
        t_reps = _drive(ts, TM.init_caches(tcfg, B, 32, device="cpu"), _toks(tcfg), 4)
        _same_reports(t_reps, j_reps)
        assert any(r.shipped for r in t_reps) and any(r.exited_on_edge.any()
                                                      for r in t_reps)
        assert t_reps[0].sim_transfer_s == (
            pytest.approx(t_reps[0].bytes_shipped * 8.0 / bw),)

    @pytest.mark.parametrize("overlap", ["serial", "pipelined"])
    def test_three_tier_equals_the_reference(self, deep_model, overlap):
        jp, tp, thr = deep_model
        jcfg, tcfg = _cfgs(thr)
        specs = (("device", 50.0, PER_SEQ * B * 8.0 / 0.004),
                 ("edge", 10.0, PER_SEQ * B * 8.0 / 0.002), ("cloud", 1.0))
        jprof, tprof = _profiles((jcfg, tcfg))
        js = JMultiTierServer(jcfg, jp, [JTierSpec(*s) for s in specs], (1, 3),
                              cost=(jprof.t_c, jprof.alpha), simulate_network=True,
                              overlap=overlap, use_kernels=False)
        ts = MultiTierServer(tcfg, tp, [TierSpec(*s) for s in specs], (1, 3),
                             cost=(tprof.t_c, tprof.alpha), simulate_network=True,
                             overlap=overlap, device="cpu")
        j_reps = _drive(js, JM.init_caches(jcfg, B, 32), jnp.asarray(_toks(jcfg)), 4)
        t_reps = _drive(ts, TM.init_caches(tcfg, B, 32, device="cpu"), _toks(tcfg), 4)
        _same_reports(t_reps, j_reps, hops=2)
        assert all(r.transfer_s_per_hop == pytest.approx(r.sim_transfer_s)
                   for r in t_reps)

    def test_wall_clock_pays_the_uplink(self, deep_model):
        jp, tp, thr = deep_model
        _, tcfg = _cfgs(thr)
        bw = PER_SEQ * 4 * 8.0 / 0.04  # ~40 ms at 4 rows
        srv = PartitionedServer(tcfg, tp, 2, network=NetworkProfile("slow", bw),
                                simulate_network=True, compaction="off", device="cpu")
        caches = TM.init_caches(tcfg, 4, 32, device="cpu")
        tok = _toks(tcfg, 4)
        rep, caches = srv.step(tok, 0, caches)
        t0 = time.perf_counter()
        rep, caches = srv.step(tok, 1, caches)
        dt = time.perf_counter() - t0
        expected = rep.bytes_shipped * 8.0 / bw
        assert rep.sim_transfer_s == (pytest.approx(expected),)
        if rep.shipped:
            assert dt >= 0.9 * expected

    def test_no_simulation_by_default(self, deep_model):
        jp, tp, thr = deep_model
        _, tcfg = _cfgs(thr)
        srv = PartitionedServer(tcfg, tp, 2, network=NetworkProfile("fast", 1e9),
                                device="cpu")
        rep, _ = srv.step(_toks(tcfg, 4), 0, TM.init_caches(tcfg, 4, 32, device="cpu"))
        assert rep.sim_transfer_s == ()


class TestDeadUplink:
    def test_unset_uplink_raises(self, deep_model):
        """Bytes queued on a hop with no uplink and no fault model raise
        (the reference raises the same), instead of a free transfer."""
        jp, tp, _ = deep_model
        jcfg, tcfg = _cfgs(0.0)  # nobody exits
        ex = TierExecutor(tcfg, tp, segments_for_cuts(tcfg, (2,)),
                          simulate_network=True, device="cpu")
        with pytest.raises(LinkDownError, match="hop 0"):
            ex.step(_toks(tcfg), 0, TM.init_caches(tcfg, B, 32, device="cpu"))
        jex = JExecutor(jcfg, jp, jsegments(jcfg, (2,)), simulate_network=True,
                        use_kernels=False)
        with pytest.raises(Exception, match="hop 0"):
            jex.step(jnp.asarray(_toks(jcfg)), 0, JM.init_caches(jcfg, B, 32))

    def test_zero_uplink_raises_and_no_payload_does_not(self, deep_model):
        _, tp, _ = deep_model
        for thr, raises in ((0.0, True), (float("inf"), False)):
            _, tcfg = _cfgs(thr)
            ex = TierExecutor(tcfg, tp, segments_for_cuts(tcfg, (2,), uplinks=(0.0,)),
                              simulate_network=True, device="cpu")
            caches = TM.init_caches(tcfg, B, 32, device="cpu")
            if raises:
                with pytest.raises(LinkDownError):
                    ex.step(_toks(tcfg), 0, caches)
            else:
                res, _ = ex.step(_toks(tcfg), 0, caches)
                assert res.exited.all() and res.bytes_per_hop == (0.0,)

    def test_fault_model_degrades_instead(self, deep_model):
        _, tp, _ = deep_model
        _, tcfg = _cfgs(0.0)
        ex = TierExecutor(tcfg, tp, segments_for_cuts(tcfg, (2,)),
                          simulate_network=True, device="cpu",
                          fault_model=LinkFaultModel(seed=0))
        res, _ = ex.step(_toks(tcfg), 0, TM.init_caches(tcfg, B, 32, device="cpu"))
        assert res.degraded_hop == 0 and res.exited.all()


def _run(tp, tcfg, cuts, overlap, *, compaction="bucketed", steps=4, uplinks=None,
         batch=B):
    ex = TierExecutor(tcfg, tp, segments_for_cuts(
        tcfg, cuts, uplinks=uplinks or (PER_SEQ * batch * 8.0 / 0.002,) * len(cuts)),
        compaction=compaction, simulate_network=True, overlap=overlap, device="cpu")
    caches = TM.init_caches(tcfg, batch, 64, device="cpu")
    tok, out = _toks(tcfg, batch), []
    for i in range(steps):
        res, caches = ex.step(tok, i, caches)
        out.append(res)
        tok = res.tokens_dev[:, None]
    ex.drain()
    return ex, out


class TestPipelined:
    @pytest.mark.parametrize("cuts", [(), (2,), (2, 3), (1, 3)])
    @pytest.mark.parametrize("compaction", ["bucketed", "off"])
    def test_bitwise_equal_to_serial(self, deep_model, cuts, compaction):
        _, tp, thr = deep_model
        _, tcfg = _cfgs(thr)
        exs, outs_s = _run(tp, tcfg, cuts, "serial", compaction=compaction)
        exp, outs_p = _run(tp, tcfg, cuts, "pipelined", compaction=compaction)
        for a, b in zip(outs_s, outs_p):
            for f in ("tokens", "exited", "exit_tier"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert a.shipped_per_hop == b.shipped_per_hop
            assert a.bytes_per_hop == b.bytes_per_hop
            assert a.sim_transfer_s == b.sim_transfer_s
            assert a.compaction == b.compaction
            assert a.last_logits.equal(b.last_logits)
            for layer, take in a.branch_take.items():
                np.testing.assert_array_equal(take, b.branch_take[layer])
        assert exs.host_syncs == 4 + exs.overflow_retries
        assert exp.host_syncs == 4 + exp.overflow_retries
        assert exp.pipeline_fallbacks == exp.overflow_retries

    def test_drain_is_idempotent_and_resets(self, deep_model):
        _, tp, thr = deep_model
        _, tcfg = _cfgs(thr)
        ex, _ = _run(tp, tcfg, (2,), "pipelined")
        assert ex._link_free == [] and ex._inflight_done == 0.0
        ex.drain()
        assert ex._link_free == []

    def test_rejects_unknown_overlap_mode(self, deep_model):
        _, tp, thr = deep_model
        _, tcfg = _cfgs(thr)
        with pytest.raises(ValueError, match="overlap"):
            TierExecutor(tcfg, tp, segments_for_cuts(tcfg, (2,)), overlap="async",
                         device="cpu")

    def test_overflow_retry_falls_back_to_serial(self, deep_model):
        """A forced overflow re-run drains the pipeline and pays its
        transfers inline; tokens stay those of the masked serial path,
        and pipelining resumes on the next step."""
        _, tp, _ = deep_model
        _, tcfg = _cfgs(0.0)  # no exits: all 8 rows survive
        exm = TierExecutor(tcfg, tp, segments_for_cuts(tcfg, (2,)), compaction="off",
                           device="cpu")
        exc = TierExecutor(tcfg, tp, segments_for_cuts(tcfg, (2,), uplinks=(1e9,)),
                           simulate_network=True, overlap="pipelined", device="cpu")
        cm, cc = (TM.init_caches(tcfg, B, 32, device="cpu") for _ in range(2))
        rm, cm = exm.step(_toks(tcfg), 0, cm)
        rc, cc = exc.step(_toks(tcfg), 0, cc)
        np.testing.assert_array_equal(rm.tokens, rc.tokens)
        exc._hints = {1: 1}  # a stale all-exit hint: 8 survivors arrive
        rm, cm = exm.step(rm.tokens_dev[:, None], 1, cm)
        rc, cc = exc.step(rc.tokens_dev[:, None], 1, cc)
        np.testing.assert_array_equal(rm.tokens, rc.tokens)
        assert exc.overflow_retries == exc.pipeline_fallbacks == 1
        assert exc._link_free == []  # the fallback drained the pipeline
        rm, cm = exm.step(rm.tokens_dev[:, None], 2, cm)
        rc, cc = exc.step(rc.tokens_dev[:, None], 2, cc)
        np.testing.assert_array_equal(rm.tokens, rc.tokens)
        assert exc.pipeline_fallbacks == 1 and exc._link_free != []
        assert exc.host_syncs == 4

    def test_steady_state_beats_the_serial_sum(self, deep_model, monkeypatch):
        """Transfer-bound K=3 (hops of 40 and 25 ms) on a host clock that
        only sleeps move, so compute takes no time and the link clocks
        alone set the pace: serial pays both hops every step (4 x 65 ms),
        pipelined the slower hop once the pipe is full (the 4 steps and
        the drain end at 40 + 40 + 40 + 65 = 185 ms)."""
        clock = types.SimpleNamespace(now=0.0)
        clock.perf_counter = lambda: clock.now
        clock.sleep = lambda s: setattr(clock, "now", clock.now + max(s, 0.0))
        monkeypatch.setattr(tiers_mod, "time", clock)
        _, tp, _ = deep_model
        _, tcfg = _cfgs(0.0)  # every row ships
        batch = 4
        uplinks = tuple(PER_SEQ * batch * 8.0 / s for s in (0.04, 0.025))
        times = {}
        for overlap in ("serial", "pipelined"):
            ex = TierExecutor(tcfg, tp, segments_for_cuts(tcfg, (2, 3), uplinks=uplinks),
                              compaction="off", simulate_network=True, overlap=overlap,
                              device="cpu")
            caches = TM.init_caches(tcfg, batch, 64, device="cpu")
            res, caches = ex.step(_toks(tcfg, batch), 0, caches)
            ex.drain()
            t0 = clock.now
            for i in range(1, 5):
                res, caches = ex.step(res.tokens_dev[:, None], i, caches)
            ex.drain()
            times[overlap] = clock.now - t0
            assert res.sim_transfer_s == (pytest.approx(0.04), pytest.approx(0.025))
        assert times["serial"] == pytest.approx(4 * 0.065)
        assert times["pipelined"] == pytest.approx(0.185)


class TestController:
    def test_pipelined_server_solves_the_bottleneck_stage(self, deep_model):
        """The installed cut minimizes the overlap objective, as the
        reference's controller's does."""
        jp, tp, _ = deep_model
        jcfg, tcfg = _cfgs()
        p_k = np.array([0.1, 0.1])
        jprof, tprof = _profiles((jcfg, tcfg), p_k)
        js = JPartitionedServer(jcfg, jp, 0, cost_profile=jprof,
                                network=JNetworkProfile("3g", 1.1e6),
                                overlap="pipelined", use_kernels=False)
        ts = PartitionedServer(tcfg, tp, 0, cost_profile=tprof,
                               network=NetworkProfile("3g", 1.1e6), overlap="pipelined",
                               device="cpu")
        jctl, tctl = JController(js, jprof), RepartitionController(ts, tprof)
        (cut,) = tctl.solve(p_k)
        assert (cut,) == jctl.solve(p_k)
        prof = dataclasses.replace(tprof, branches=tuple(
            dataclasses.replace(b, exit_prob=float(p))
            for b, p in zip(tprof.branches, p_k)))
        tiers = [TierSpec("edge", prof.gamma, prof.network.bandwidth_bps),
                 TierSpec("cloud", 1.0)]
        best = min(range(tcfg.num_layers + 1), key=lambda s: expected_time_multitier(
            prof.t_c, prof.alpha, prof.branch_exit_probs(), tiers, (s,), overlap=True))
        assert cut == best
        tctl._install(p_k)
        assert ts.split_layer == cut

    def test_pipelined_multitier_solve(self, deep_model):
        jp, tp, _ = deep_model
        jcfg, tcfg = _cfgs()
        p_k = np.array([0.3, 0.1])
        jprof, tprof = _profiles((jcfg, tcfg), p_k)
        specs = (("d", 50.0, 1e6), ("e", 10.0, 1e7), ("c", 1.0))
        js = JMultiTierServer(jcfg, jp, [JTierSpec(*s) for s in specs], (1, 2),
                              overlap="pipelined", use_kernels=False)
        ts = MultiTierServer(tcfg, tp, [TierSpec(*s) for s in specs], (1, 2),
                             overlap="pipelined", device="cpu")
        for batch in (None, B):
            assert RepartitionController(ts, tprof, batch=batch).solve(p_k) == \
                JController(js, jprof, batch=batch).solve(p_k)

    def test_update_network_reinstalls_the_uplink(self, deep_model):
        jp, tp, _ = deep_model
        jcfg, tcfg = _cfgs()
        jprof, tprof = _profiles((jcfg, tcfg))
        js = JPartitionedServer(jcfg, jp, 0, cost_profile=jprof,
                                network=JNetworkProfile("wifi", 18.8e6),
                                use_kernels=False)
        ts = PartitionedServer(tcfg, tp, 0, cost_profile=tprof,
                               network=NetworkProfile("wifi", 18.8e6), device="cpu")
        jctl, tctl = JController(js, jprof), RepartitionController(ts, tprof)
        for ctl in (jctl, tctl):
            ctl._install(np.array([0.2, 0.2]))
        cuts = tctl.update_network(NetworkProfile("3g", 0.4e6))
        assert cuts == jctl.update_network(JNetworkProfile("3g", 0.4e6))
        assert ts.network.bandwidth_bps == 0.4e6
        assert [s.uplink_bps for s in ts.executor.segments] == \
            [s.uplink_bps for s in js.executor.segments]
