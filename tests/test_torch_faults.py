"""The port's fault plane against the reference on the CPU, on bridged
weights (reference ``tests/test_faults.py``).

  * ``serving/faults.py`` (the port's own copy): the pure classes of the
    reference tests — seeded draws, flap windows, per-hop knobs, backoff,
    the attempt loop's event trace and the circuit breaker — run through
    both packages, with draws and events equal;
  * degraded steps, step by step against the reference's ``TierExecutor``:
    tokens, exit masks, exit tiers, ``degraded`` / ``failed`` masks, fault
    events, bytes and simulated transfer seconds equal (fp32 compute);
  * the port's own invariants, exactly: a benign model is invisible, a
    degraded step bumps the cache clock once and makes one sync, its
    fallback key is cached like any other, and a step with no head below
    the broken hop dispatches and fetches nothing;
  * the scheduler's failed / degraded slots and the controller's hop
    health (reference TestSchedulerFaults, TestControllerHopHealth) on the
    same inputs through both packages.

The reference's kernel-path case (Pallas in interpret mode) has no CPU
counterpart: the port's kernels run only on the card, where
``chip_smoke.py`` holds degraded graphed steps against eager ones.

Fixture: the ``phi3_mini_3_8b`` smoke config with ``num_layers=4,
branch_layers=(1, 3)`` in fp32 compute, the threshold at the midpoint of
the first step's branch entropies (a mixed exit regime), as in the
reference tests.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.core import LayerCost as JLayerCost
from repro.core import build_cost_profile as j_build_cost_profile
from repro.core.multitier import TierSpec as JTierSpec
from repro.models import model as JM
from repro.serving import MultiTierServer as JMultiTierServer
from repro.serving import RepartitionController as JController
from repro.serving import RequestScheduler as JScheduler
from repro.serving import TierExecutor as JExecutor
from repro.serving import faults as jfaults
from repro.serving import segments_for_cuts as jsegments
from repro_torch import bridge
from repro_torch.configs import ModelConfig
from repro_torch.core import LayerCost, TierSpec, build_cost_profile
from repro_torch.core.multitier import _hop_seconds, solve_multitier
from repro_torch.models import model as TM
from repro_torch.serving import (
    MultiTierServer,
    RepartitionController,
    RequestScheduler,
    TierExecutor,
    segments_for_cuts,
)
from repro_torch.serving import faults as tfaults

B = 8
PACKAGES = pytest.mark.parametrize("F", [jfaults, tfaults],
                                   ids=["reference", "port"])


def _cfgs(thr=0.5, **kw):
    jcfg = dataclasses.replace(get_smoke_config("phi3_mini_3_8b"), num_layers=4,
                               branch_layers=(1, 3), dtype="float32",
                               exit_threshold=thr)
    jcfg = dataclasses.replace(jcfg, **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _toks(cfg):
    return np.array(jax.random.randint(jax.random.PRNGKey(2), (B, 1), 0,
                                       cfg.vocab_size))


@pytest.fixture(scope="module")
def deep_model():
    """Both packages' params and the mixed threshold."""
    jcfg, _ = _cfgs()
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    ex = JExecutor(jcfg, jp, jsegments(jcfg, ()), use_kernels=False)
    res, _ = ex.step(jnp.asarray(_toks(jcfg)), 0, JM.init_caches(jcfg, B, 32))
    ents = np.concatenate([res.branch_entropy[l] for l in jcfg.branch_layers])
    return jp, tp, float((ents.min() + ents.max()) / 2)


def _fault_kw(F, fm, hp):
    """A fault model and policy spec as the package ``F``'s objects."""
    def conv(obj):
        if obj is None:
            return None
        kw = dataclasses.asdict(obj)
        if "flaps" in kw:
            kw["flaps"] = tuple(F.FlapWindow(**w) for w in kw["flaps"])
        return getattr(F, type(obj).__name__)(**kw)
    return dict(fault_model=conv(fm), hop_policy=conv(hp))


def _decode(deep_model, cuts, *, fm=None, hp=None, steps=5, port=True, cfg_kw=None,
            **kw):
    """``steps`` lock-step decode steps on one package's executor (uplinks
    1e9 b/s, so the sleeps are microseconds); returns (executor, history,
    caches)."""
    jp, tp, thr = deep_model
    jcfg, tcfg = _cfgs(thr, **(cfg_kw or {}))
    if port:
        ex = TierExecutor(tcfg, tp, segments_for_cuts(tcfg, cuts, uplinks=(1e9,) * len(cuts)),
                          simulate_network=True, device="cpu",
                          **_fault_kw(tfaults, fm, hp), **kw)
        caches = TM.init_caches(tcfg, B, 32, device="cpu")
        tok = _toks(jcfg)
    else:
        ex = JExecutor(jcfg, jp, jsegments(jcfg, cuts, uplinks=(1e9,) * len(cuts)),
                       simulate_network=True, use_kernels=False,
                       **_fault_kw(jfaults, fm, hp), **kw)
        caches = JM.init_caches(jcfg, B, 32)
        tok = jnp.asarray(_toks(jcfg))
    hist = []
    for i in range(steps):
        res, caches = ex.step(tok, i, caches)
        hist.append(res)
        tok = res.tokens_dev[:, None]
    return ex, hist, caches


KILL_HOP1 = tfaults.LinkFaultModel(
    seed=0, flaps=(tfaults.FlapWindow(hop=1, start_step=2, end_step=10_000),))
FAST_POLICY = tfaults.HopPolicy(timeout_s=0.01, max_retries=1, backoff_s=0.001,
                                breaker_threshold=2, breaker_cooldown_steps=3)


def _events(res):
    return [dataclasses.astuple(e) for e in res.fault_events]


def _same_steps(port_hist, ref_hist):
    """Step by step: everything the fault plane decides is exactly equal;
    main-head logits within 1e-5 (fp32)."""
    assert len(port_hist) == len(ref_hist)
    for t, j in zip(port_hist, ref_hist):
        np.testing.assert_array_equal(t.tokens, np.asarray(j.tokens))
        np.testing.assert_array_equal(t.exited, np.asarray(j.exited))
        np.testing.assert_array_equal(t.exit_tier, j.exit_tier)
        for name in ("degraded", "failed"):
            a, b = getattr(t, name), getattr(j, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a, b)
        assert _events(t) == _events(j)
        assert t.degraded_hop == j.degraded_hop
        assert t.shipped_per_hop == j.shipped_per_hop
        assert t.bytes_per_hop == j.bytes_per_hop
        assert t.sim_transfer_s == j.sim_transfer_s
        assert sorted(t.branch_take) == sorted(j.branch_take)
        for layer, take in j.branch_take.items():
            np.testing.assert_array_equal(t.branch_take[layer], take)
        assert (t.last_logits is None) == (j.last_logits is None)
        if j.last_logits is not None:
            np.testing.assert_allclose(t.last_logits.numpy(),
                                       np.asarray(j.last_logits), rtol=0, atol=1e-5)


# --------------------------------------------------------------- faults.py
class TestLinkFaultModel:
    @PACKAGES
    def test_draw_deterministic_and_prefix_stable(self, F):
        m = F.LinkFaultModel(seed=3, drop_p=0.5, spike_p=0.3, spike_s=0.01)
        c1, j1, d1 = m.draw(2, 0, 3)
        c2, j2, d2 = m.draw(2, 0, 3)
        assert c1 == c2 and j1 == j2 and np.array_equal(d1, d2)
        _, _, d5 = m.draw(2, 0, 5)
        assert np.array_equal(d1, d5[:3])
        assert not all(np.array_equal(m.draw(s, h, 8)[2], m.draw(2, 0, 8)[2])
                       for s, h in [(3, 0), (2, 1)])

    def test_draws_replay_the_reference(self):
        """Every (seed, step, hop) PCG64 draw bit for bit, per-hop knobs and
        flap windows included."""
        kw = dict(drop_p={0: 0.4, 1: 0.7}, bandwidth_mult={1: 0.5}, spike_p=0.3,
                  spike_s={0: 0.02})
        for seed in (0, 3, 7):
            jm = jfaults.LinkFaultModel(
                seed=seed, flaps=(jfaults.FlapWindow(1, 2, 5),), **kw)
            tm = tfaults.LinkFaultModel(
                seed=seed, flaps=(tfaults.FlapWindow(1, 2, 5),), **kw)
            for step in range(8):
                for hop in range(3):
                    jc, ju, jd = jm.draw(step, hop, 4)
                    tc, tu, td = tm.draw(step, hop, 4)
                    assert dataclasses.astuple(jc) == dataclasses.astuple(tc)
                    assert ju == tu and np.array_equal(jd, td)

    @PACKAGES
    def test_flap_windows(self, F):
        m = F.LinkFaultModel(seed=0, flaps=(F.FlapWindow(hop=1, start_step=5,
                                                         end_step=8),))
        assert m.flapped(5, 1) and m.flapped(7, 1)
        assert not m.flapped(8, 1) and not m.flapped(6, 0)
        assert m.condition(6, 1).flapped and not m.condition(4, 1).flapped

    @PACKAGES
    def test_per_hop_mapping_knobs(self, F):
        m = F.LinkFaultModel(seed=0, drop_p={0: 1.0}, bandwidth_mult={1: 0.5})
        _, _, d0 = m.draw(0, 0, 4)
        _, _, d1 = m.draw(0, 1, 4)
        assert d0.all() and not d1.any()
        assert m.condition(0, 0).bandwidth_mult == 1.0
        assert m.condition(0, 1).bandwidth_mult == 0.5


class TestHopPolicy:
    @PACKAGES
    def test_backoff_exponential_with_jitter(self, F):
        p = F.HopPolicy(backoff_s=0.01, backoff_mult=2.0, jitter_frac=0.5)
        assert p.backoff(1) == pytest.approx(0.01)
        assert p.backoff(2) == pytest.approx(0.02)
        assert p.backoff(3) == pytest.approx(0.04)
        assert p.backoff(1, jitter_u=1.0) == pytest.approx(0.015)

    @pytest.mark.parametrize("case", [
        # (condition, drops, attempts, est_bytes, uplink_bps, policy kw)
        (dict(flapped=True), [False, False], 2, 100.0, 1e9,
         dict(timeout_s=0.01, max_retries=1, backoff_s=0.002)),
        ({}, [True, False, False], 3, 1000.0, 1e9,
         dict(timeout_s=0.05, max_retries=2, backoff_s=0.001)),
        ({}, [False], 1, 10e6, 1e6, dict(timeout_s=0.001, max_retries=0)),
        (dict(bandwidth_mult=0.0), [False, False], 2, 10.0, 1e9,
         dict(timeout_s=0.01, max_retries=1, jitter_frac=0.5)),
        (dict(latency_s=0.02), [False, True], 2, 10.0, 1e9,
         dict(timeout_s=0.03, max_retries=1, backoff_mult=3.0)),
    ], ids=["down", "drop-then-ok", "timeout", "zero-bandwidth", "spike"])
    def test_attempt_hop_equals_the_reference(self, case):
        """Outcome, overhead and the pinned event trace (reference
        ``test_attempt_hop_*``) equal through both packages."""
        cond, drops, attempts, nbytes, up, pol = case
        outs = [F.attempt_hop(F.HopPolicy(**pol), F.HopCondition(**cond), drops, 0.7,
                              step=4, hop=1, est_bytes=nbytes, uplink_bps=up,
                              attempts=attempts)
                for F in (jfaults, tfaults)]
        j, t = outs
        assert (t.ok, t.attempts, t.overhead_s, t.bandwidth_mult, t.latency_s) == \
            (j.ok, j.attempts, j.overhead_s, j.bandwidth_mult, j.latency_s)
        assert [dataclasses.astuple(e) for e in t.events] == \
            [dataclasses.astuple(e) for e in j.events]
        if case[0].get("flapped"):
            assert [e.kind for e in t.events] == ["link_down", "retry", "link_down",
                                                 "exhausted"]
            assert t.overhead_s == pytest.approx(2 * 0.01 + 0.002)


class TestCircuitBreaker:
    @PACKAGES
    def test_transitions(self, F):
        b = F.CircuitBreaker(F.HopPolicy(breaker_threshold=3, breaker_cooldown_steps=4))
        assert b.gate(0) == "attempt"
        for s in range(3):
            b.record(s, ok=False)
        assert b.state == "open"
        assert b.gate(3) == "skip"
        assert b.gate(2 + 4) == "probe" and b.state == "half_open"
        b.record(6, ok=True)
        assert b.state == "closed" and b.failures == 0

    @PACKAGES
    def test_half_open_failure_reopens(self, F):
        b = F.CircuitBreaker(F.HopPolicy(breaker_threshold=2, breaker_cooldown_steps=2))
        b.record(0, ok=False)
        b.record(1, ok=False)
        assert b.gate(1 + 2) == "probe"
        b.record(3, ok=False)
        assert b.state == "open" and b.gate(4) == "skip" and b.gate(3 + 2) == "probe"

    def test_seeded_sequence_equals_the_reference(self):
        """A long seeded record/gate sequence: equal transitions."""
        rng = np.random.default_rng(0)
        oks = rng.random(60) < 0.4
        trans = []
        for F in (jfaults, tfaults):
            b = F.CircuitBreaker(F.HopPolicy(breaker_threshold=2,
                                             breaker_cooldown_steps=3))
            gates = []
            for s, ok in enumerate(oks):
                gates.append(b.gate(s))
                if gates[-1] != "skip":
                    b.record(s, bool(ok))
            trans.append((gates, b.transitions))
        assert trans[0] == trans[1]


# --------------------------------------------------------- degraded steps
class TestDegradedSteps:
    @pytest.mark.parametrize("cuts,fm", [
        ((1, 3), KILL_HOP1),
        ((2,), tfaults.LinkFaultModel(
            seed=0, flaps=(tfaults.FlapWindow(hop=0, start_step=0, end_step=10),))),
        ((1, 3), tfaults.LinkFaultModel(
            seed=7, drop_p=0.3, spike_p=0.2, spike_s=0.005,
            flaps=(tfaults.FlapWindow(hop=1, start_step=3, end_step=5),))),
    ], ids=["kill-hop1", "kill-hop0", "seeded-drops-and-flap"])
    def test_steps_equal_the_reference(self, deep_model, cuts, fm):
        """A link kill degrades through the deepest head at or below the
        broken hop (at (1, 3) branch 3, which the healthy plan discards
        at the cut); seeded drops, spikes and a finite flap replay the
        reference's events, retries and masks."""
        ex, hist, _ = _decode(deep_model, cuts, fm=fm, hp=FAST_POLICY, steps=6)
        jex, jhist, _ = _decode(deep_model, cuts, fm=fm, hp=FAST_POLICY, steps=6,
                                port=False)
        _same_steps(hist, jhist)
        assert (ex.degraded_steps, ex.failed_steps, ex.fault_retries, ex.fault_step,
                ex.host_syncs) == (jex.degraded_steps, jex.failed_steps,
                                   jex.fault_retries, jex.fault_step, jex.host_syncs)
        assert ex.degraded_steps > 0
        # The degraded terminal segment's key (its last spec field the
        # fallback layer) is built exactly as the reference traces it.
        assert ex.trace_counts == {
            ((lo, hi, br, head, probe, pm, deg), b): n
            for ((lo, hi, br, head, _dev, probe, pm, deg), b), n
            in jex.trace_counts.items()}
        for res in hist:
            if res.degraded is not None and res.degraded.any():
                assert res.exited.all()
                for take in res.branch_take.values():
                    assert not (take & res.degraded).any()  # forced: no take

    def test_sequential_heads_degrade_like_batched(self, deep_model):
        """``batched_heads=False`` (one projection and decision per head)
        degrades to the same tokens, masks and events as the stacked path."""
        kw = dict(fm=KILL_HOP1, hp=FAST_POLICY, steps=5)
        _, batched, _ = _decode(deep_model, (1, 3), **kw)
        _, sequential, _ = _decode(deep_model, (1, 3), batched_heads=False, **kw)
        for a, b in zip(batched, sequential):
            for f in ("tokens", "exited", "exit_tier"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert _events(a) == _events(b) and a.degraded_hop == b.degraded_hop
            if a.degraded is not None:
                np.testing.assert_array_equal(a.degraded, b.degraded)
        assert any(r.degraded_hop == 1 for r in sequential)

    def test_no_head_below_the_hop_fails_like_the_reference(self, deep_model):
        kw = dict(cfg_kw=dict(branch_layers=(3,), exit_threshold=0.0), steps=2,
                  fm=tfaults.LinkFaultModel(seed=0, flaps=(tfaults.FlapWindow(0, 0, 10),)),
                  hp=FAST_POLICY)
        jp, tp, thr = deep_model
        one = ({**jp, "branches": {"scale": jp["branches"]["scale"][1:]}},
               {**tp, "branches": {"scale": tp["branches"]["scale"][1:]}}, thr)
        ex, hist, _ = _decode(one, (2,), **kw)
        jex, jhist, _ = _decode(one, (2,), port=False, **kw)
        _same_steps(hist, jhist)
        assert hist[0].failed.all() and ex.failed_steps == jex.failed_steps == 2

    @pytest.mark.parametrize("cuts", [(2,), (1, 3)])
    @pytest.mark.parametrize("compaction", ["bucketed", "off"])
    def test_benign_model_is_bitwise_invisible(self, deep_model, cuts, compaction):
        """A benign model (no flaps, drops or spikes, multiplier 1) leaves
        every token, mask, byte count and cache tensor bitwise as without
        it."""
        _, base, c0 = _decode(deep_model, cuts, compaction=compaction)
        _, ben, c1 = _decode(deep_model, cuts, compaction=compaction,
                             fm=tfaults.LinkFaultModel(seed=0))
        for a, b in zip(base, ben):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(a.exited, b.exited)
            np.testing.assert_array_equal(a.exit_tier, b.exit_tier)
            assert a.bytes_per_hop == b.bytes_per_hop
            assert a.last_logits.equal(b.last_logits)
            assert not b.degraded_hop and (b.degraded is None or not b.degraded.any())
        assert all(x.equal(y) for x, y in zip(_flat(c0), _flat(c1)))

    def test_degraded_step_clock_sync_and_key(self, deep_model):
        """One cache-clock bump and one host sync per degraded step; the
        fallback segment is a key of its own (its ``degrade`` field the
        fallback layer), built once and then reused."""
        ex, hist, caches = _decode(deep_model, (1, 3), fm=KILL_HOP1, hp=FAST_POLICY,
                                   steps=6)
        assert int(caches["length"]) == 6 and ex.host_syncs == 6 + ex.overflow_retries
        deg_keys = {k: n for k, n in ex.trace_counts.items() if k[0][6] is not None}
        assert deg_keys and {k[0][6] for k in deg_keys} == {3}
        assert all(n == 1 for n in deg_keys.values())
        assert sum(r.degraded_hop == 1 for r in hist) == ex.degraded_steps >= 3

    def test_failed_step_dispatches_and_fetches_nothing(self, deep_model):
        jp, tp, thr = deep_model
        _, tcfg = _cfgs(0.0, branch_layers=(3,))
        tp = {**tp, "branches": {"scale": tp["branches"]["scale"][1:]}}
        ex = TierExecutor(tcfg, tp, segments_for_cuts(tcfg, (2,), uplinks=(1e9,)),
                          simulate_network=True, device="cpu",
                          fault_model=tfaults.LinkFaultModel(
                              seed=0, flaps=(tfaults.FlapWindow(0, 0, 10),)),
                          hop_policy=FAST_POLICY)
        caches = TM.init_caches(tcfg, B, 32, device="cpu")
        before = [t.clone() for t in _flat(caches)]
        res, caches = ex.step(_toks(tcfg), 0, caches, active=np.arange(B) < 6)
        assert ex.host_syncs == 0 and ex.trace_counts == {} and ex.failed_steps == 1
        assert all(x.equal(y) for x, y in zip(before, _flat(caches)))
        np.testing.assert_array_equal(res.failed, np.arange(B) < 6)
        assert not res.degraded.any() and (res.exit_tier == -1).all()
        assert res.last_logits is None and res.sim_transfer_s == (
            pytest.approx(2 * 0.01 + 0.001),)


def _flat(tree):
    for v in tree.values():
        yield from _flat(v) if isinstance(v, dict) else (v,)


# -------------------------------------------------- scheduler, controller
def _tiers(mod, specs):
    return [mod(*s) for s in specs]


THREE = (("edge", 4.0, 1e9), ("mid", 2.0, 1e9), ("cloud", 1.0))
TWO = (("edge", 4.0, 1e9), ("cloud", 1.0))


def _servers(deep_model, fm, hp, *, specs=THREE, cuts=(1, 3), slots=4, cfg_kw=None,
             branches=None):
    """The reference's and the port's MultiTierServer with the same
    fault model (simulate_network, 64-slot context)."""
    jp, tp, thr = deep_model
    jcfg, tcfg = _cfgs(thr, **(cfg_kw or {}))
    if branches is not None:
        jp = {**jp, "branches": {"scale": jp["branches"]["scale"][np.array(branches)]}}
        tp = {**tp, "branches": {"scale": tp["branches"]["scale"][branches]}}
    js = JMultiTierServer(jcfg, jp, _tiers(JTierSpec, specs), cuts,
                          simulate_network=True, slots=slots, context_len=64,
                          use_kernels=False, **_fault_kw(jfaults, fm, hp))
    ts = MultiTierServer(tcfg, tp, _tiers(TierSpec, specs), cuts,
                         simulate_network=True, slots=slots, context_len=64,
                         device="cpu", **_fault_kw(tfaults, fm, hp))
    return js, ts


def _prompts(cfg, n, plen, seed=5):
    r = np.random.default_rng(seed)
    return [r.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
            for _ in range(n)]


def _summary(results):
    return [(r.rid, r.status, r.tokens, r.exited, r.exit_tiers, r.degraded_tokens,
             r.slot) for r in results]


class TestSchedulerFaults:
    def test_drain_completes_under_link_kill(self, deep_model):
        fm = tfaults.LinkFaultModel(
            seed=0, flaps=(tfaults.FlapWindow(hop=1, start_step=4, end_step=10_000),))
        out = []
        for srv, sched_cls in zip(_servers(deep_model, fm, FAST_POLICY),
                                  (JScheduler, RequestScheduler)):
            sched = sched_cls(srv, 4, 64)
            for p in _prompts(srv.cfg, 8, 6):
                sched.submit(p, 8)
            results = sched.drain()
            assert len(results) == 8 and all(r.done for r in results)
            assert {r.status for r in results} <= {"ok", "degraded"}
            assert sum(r.degraded_tokens for r in results) > 0
            assert sched.active.sum() == 0 and all(r is None for r in sched._slot_req)
            out.append(_summary(results))
        assert out[0] == out[1]

    def test_terminal_failed_reclaims_slots(self, deep_model):
        fm = tfaults.LinkFaultModel(
            seed=0, flaps=(tfaults.FlapWindow(hop=0, start_step=0, end_step=10_000),))
        out = []
        for srv, sched_cls in zip(
                _servers(deep_model, fm, FAST_POLICY, specs=TWO, cuts=(2,), slots=2,
                         cfg_kw=dict(branch_layers=(3,), exit_threshold=0.0),
                         branches=[1]),
                (JScheduler, RequestScheduler)):
            sched = sched_cls(srv, 2, 64)
            for p in _prompts(srv.cfg, 4, 6):
                sched.submit(p, 4)
            results = sched.drain()
            assert len(results) == 4
            assert all(r.done and r.status == "failed" and r.tokens == []
                       for r in results)
            assert sched.active.sum() == 0 and all(r is None for r in sched._slot_req)
            out.append(_summary(results))
        assert out[0] == out[1]

    def test_requeue_on_fail_recovers_after_flap(self, deep_model):
        fm = tfaults.LinkFaultModel(
            seed=0, flaps=(tfaults.FlapWindow(hop=0, start_step=2, end_step=5),))
        hp = tfaults.HopPolicy(timeout_s=0.01, max_retries=0, breaker_threshold=100)
        out = []
        for srv, sched_cls in zip(
                _servers(deep_model, fm, hp, specs=TWO, cuts=(2,), slots=2,
                         cfg_kw=dict(branch_layers=(3,), exit_threshold=0.0),
                         branches=[1]),
                (JScheduler, RequestScheduler)):
            sched = sched_cls(srv, 2, 64, requeue_on_fail=True, max_requeues=8)
            for p in _prompts(srv.cfg, 2, 6):
                sched.submit(p, 4)
            fails = []
            for _ in range(200):
                rep = sched.step()
                if rep is not None:
                    fails.append(rep.failed)
                if not sched.queue and not sched.active.any():
                    break
            results = [sched.results[r] for r in sorted(sched.results)]
            assert any(fails)
            assert all(r.done and r.status == "ok" and len(r.tokens) == 4
                       for r in results)
            assert sched.active.sum() == 0 and all(r is None for r in sched._slot_req)
            out.append((fails, _summary(results)))
        assert out[0] == out[1]


def _profile(mod_cost, mod_build, cfg):
    costs = [mod_cost(f"l{i}", 0, 0, cfg.d_model * 2.0, 1e-3)
             for i in range(cfg.num_layers)]
    return mod_build(costs, cfg.branch_layers, np.array([0.2, 0.2]), "3g", 50.0, 64.0)


def _report(F, events=(), broken=None, nb=(100.0, 100.0), sim=(1e-4, 1e-4)):
    return types.SimpleNamespace(
        fault_events=tuple(F.FaultEvent(*e) for e in events), degraded_hop=broken,
        bytes_per_hop=tuple(nb), sim_transfer_s=tuple(sim))


class TestControllerHopHealth:
    def test_hop_seconds_availability_math(self):
        assert _hop_seconds(8e9, 1e9) == pytest.approx(8.0)
        assert _hop_seconds(8e9, 1e9, availability=0.5) == pytest.approx(16.0)
        assert _hop_seconds(8e9, 1e9, availability=0.0) == float("inf")
        assert _hop_seconds(0.0, 1e9, availability=0.0) == 0.0

    def test_solver_avoids_dead_hop(self):
        n = 6
        t_c = np.concatenate([[0.0], np.full(n, 1e-3)])
        alpha = np.concatenate([[64.0], np.full(n, 64.0)])
        p = np.zeros(n + 1)
        p[2] = 0.6
        tiers = [TierSpec("edge", 2.0, 1e8),
                 TierSpec("mid", 1.5, 1e8, availability=0.0), TierSpec("cloud", 1.0)]
        assert solve_multitier(t_c, alpha, p, tiers).cut_after[1] == n
        healthy = [dataclasses.replace(t, availability=1.0) for t in tiers]
        assert solve_multitier(t_c, alpha, p, healthy).cut_after[1] < n

    def _controllers(self, deep_model, **kw):
        """The reference's and the port's controller on equal K=3 servers."""
        js, ts = _servers(deep_model, None, None)
        jprof = _profile(JLayerCost, j_build_cost_profile, js.cfg)
        tprof = _profile(LayerCost, build_cost_profile, ts.cfg)
        return ((JController(js, jprof, tiers=list(js.tiers), **kw), js, jfaults),
                (RepartitionController(ts, tprof, tiers=list(ts.tiers), **kw), ts,
                 tfaults))

    @staticmethod
    def _state(ctl, srv):
        return (ctl.hop_health(), ctl.fault_resolves, srv.cuts,
                [t.availability for t in srv.tiers], ctl._arrivals.tolist(),
                ctl._window_age)

    @pytest.mark.parametrize("case", [
        # reports fed in turn: (events, broken hop, bytes, sim seconds)
        [([(0, 0, "breaker_skip")], 0, (100.0, 100.0), (1e-4, 1e-4))],
        [([(3, 0, "breaker_half_open"), (3, 0, "link_down", 0), (3, 0, "exhausted", 0)],
          0, (0.0, 0.0), (0.0, 0.0))],
        [([(0, 0, "drop", 0)], None, (1000.0, 1000.0), (2e-3, 4e-3))],
        [([(2, 1, "exhausted", 1), (2, 1, "breaker_open")], 1, (100.0, 100.0),
          (1e-4, 1e-4)),
         ([(6, 1, "breaker_half_open"), (6, 1, "breaker_closed")], None,
          (100.0, 100.0), (1e-4, 1e-4))],
    ], ids=["skip-is-no-observation", "failed-probe-keeps-xfer", "both-ewmas",
            "open-then-closed"])
    @pytest.mark.parametrize("fault_resolve", [False, True])
    def test_ingest_equals_the_reference(self, deep_model, case, fault_resolve):
        """Hop-health EWMAs, breaker set, re-solves, cuts, availabilities and
        the drift window after the same reports, through both packages."""
        states = []
        for ctl, srv, F in self._controllers(deep_model, fault_resolve=fault_resolve):
            ctl._hop_xfer[0] = 5.0
            ctl._installed_p = np.array([0.2, 0.2])
            ctl._arrivals[:] = [8.0, 4.0]
            ctl._window_age = 7
            for events, broken, nb, sim in case:
                ctl._ingest_faults(_report(F, events, broken, nb, sim))
            states.append(self._state(ctl, srv))
        assert states[0] == states[1]
        health, resolves, cuts, avail, arrivals, age = states[1]
        if case[0][0][0][2] == "breaker_skip":
            assert health[0]["transfer_s"] == 5.0 and health[0]["availability"] == 1.0
        if len(case) == 2:
            assert not health[1]["open"] and health[1]["availability"] == 1.0
            assert resolves == (2 if fault_resolve else 0)

    def test_breaker_open_moves_the_cut_off_the_hop(self, deep_model):
        (_, js, _), (ctl, ts, F) = self._controllers(deep_model)
        ctl._installed_p = np.array([0.2, 0.2])
        cuts = ctl._ingest_faults(_report(F, [(2, 1, "exhausted", 1),
                                              (2, 1, "breaker_open")], 1))
        assert cuts is not None and ctl.fault_resolves == 1
        assert ts.tiers[1].availability == 0.0 and ts.cuts[1] == ts.cfg.num_layers
        assert ctl._arrivals.sum() == 0 and ctl._window_age == 0

    def test_e2e_breaker_open_moves_cut_off_sick_link(self, deep_model):
        """Link kill -> retries exhaust -> the breaker opens -> the
        controller re-solves -> the new cuts ship nothing over the sick
        hop -> every request completes; equal through both packages."""
        fm = tfaults.LinkFaultModel(
            seed=0, flaps=(tfaults.FlapWindow(hop=1, start_step=4, end_step=10_000),))
        out = []
        for srv, ctl_cls, sched_cls, cost, build in zip(
                _servers(deep_model, fm, FAST_POLICY), (JController, RepartitionController),
                (JScheduler, RequestScheduler), (JLayerCost, LayerCost),
                (j_build_cost_profile, build_cost_profile)):
            ctl = ctl_cls(srv, _profile(cost, build, srv.cfg), tiers=list(srv.tiers))
            sched = sched_cls(srv, 4, 64, on_step=[ctl.observe])
            for p in _prompts(srv.cfg, 8, 6):
                sched.submit(p, 10)
            results = sched.drain()
            assert all(r.done for r in results) and ctl.fault_resolves >= 1
            assert srv.tiers[1].availability == 0.0
            assert srv.cuts[1] == srv.cfg.num_layers
            assert sched.active.sum() == 0
            out.append((_summary(results), srv.cuts, ctl.fault_resolves,
                        ctl.hop_health()))
        assert out[0] == out[1]


def test_serve_partitioned_example_on_the_cpu(capsys):
    """``python -m repro_torch.examples.serve_partitioned --device cpu``:
    the example's own asserts hold (the breaker opens, the controller
    re-solves and the last cut moves to the trunk's end)."""
    from repro_torch.examples import serve_partitioned

    out = serve_partitioned.main(["--device", "cpu"])
    assert out["fault_resolves"] >= 1 and out["fault_cuts"][1] == 4
    assert "every request completed despite the dead link" in capsys.readouterr().out
