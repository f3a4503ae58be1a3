"""The port's control plane (``repro_torch.core``) against the reference
``repro.core`` on the CPU.

The solvers, cost models and calibration are numpy in both packages: on
the reference tests' inputs and hypothesis strategies, plans, splits and
costs must be *identical* (the same float64 arithmetic).  The tensor
closed form ``chain_costs_torch`` is held against the numpy closed form at
1e-12 in float64 and against ``chain_costs_jax`` / ``jax.grad`` at 1e-5 in
float32 (JAX runs without x64 here); its autograd gradients against
float64 finite differences.  The profiler's analyze mode counts FLOPs and
bytes of the plain lowering: FLOPs equal the closed-form product count and
lie within 1% of XLA's count (XLA adds the elementwise ops), bytes lie at
or above the weights + cache + activation bytes and within 15% of XLA's
fused count (ours are unfused).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

import repro.core as J
import repro_torch.core as T
from repro.configs import get_smoke_config
from repro.core import dag as jdag
from repro.core import multitier as jmt
from repro.core import profiler as jprof
from repro.models import model as JM
from repro_torch import bridge
from repro_torch.configs import ModelConfig
from repro_torch.core import dag as tdag
from repro_torch.core import multitier as tmt
from repro_torch.core import profiler as tprof

F64 = torch.float64


def profiles(t_c, alpha, branch_pos, probs, gamma=10.0, bw=5.85e6,
             include_bc=False, bc=None):
    """The same cost profile in both packages (``t_c`` without slot 0)."""
    def make(pkg):
        branches = tuple(
            pkg.BranchSpec(p, q, compute_time_cloud=(bc[i] if bc else 0.0))
            for i, (p, q) in enumerate(zip(branch_pos, probs)))
        return pkg.CostProfile(
            t_c=np.concatenate([[0.0], np.asarray(t_c, float)]),
            alpha=np.asarray(alpha, float), branches=branches, gamma=gamma,
            network=pkg.NetworkProfile("test", bw), include_branch_compute=include_bc)
    return make(J), make(T)


def same_plan(a, b):
    assert dataclasses.astuple(a) == dataclasses.astuple(b)


def random_profiles(rng):
    n = int(rng.integers(2, 9))
    t_c = rng.uniform(1e-3, 1e-1, n)
    alpha = rng.uniform(1e3, 1e6, n + 1)
    k = int(rng.integers(0, n))
    pos = sorted(rng.choice(np.arange(1, n), size=k, replace=False).tolist())
    probs = rng.uniform(0, 1, k).tolist()
    return profiles(t_c, alpha, pos, probs, gamma=float(rng.uniform(1, 1000)))


# ------------------------------------------------------------------ types
class TestTypes:
    def test_paper_presets_verbatim_tpu_presets_gone(self):
        for name in ("3g", "4g", "wifi"):
            assert dataclasses.astuple(T.UPLINK_PRESETS[name]) == \
                dataclasses.astuple(J.UPLINK_PRESETS[name])
            assert type(T.UPLINK_PRESETS[name]).__module__ == "repro_torch.core.types"
        assert not {"dcn", "ici"} & T.UPLINK_PRESETS.keys()
        assert T.UPLINK_PRESETS["nvlink4"].bandwidth_bps == 450e9 * 8
        assert T.UPLINK_PRESETS["ndr400"].bandwidth_bps == 400e9

    def test_profile_quantities_identical(self):
        jp, tp = profiles([0.01, 0.02, 0.03], [1e6, 1e5, 1e4, 1e3], [1, 2],
                          [0.3, 0.6], gamma=7.0)
        for attr in ("t_e", "t_net"):
            np.testing.assert_array_equal(getattr(tp, attr), getattr(jp, attr))
        for fn in ("branch_exit_probs", "survival_after", "p_Y"):
            np.testing.assert_array_equal(getattr(tp, fn)(), getattr(jp, fn)())
        plan_j = J.plan_from_split(jp, 2)
        plan_t = T.plan_from_split(tp, 2)
        same_plan(plan_t, plan_j)
        assert plan_t.describe() == plan_j.describe()

    @pytest.mark.parametrize("bad", [dict(gamma=0.5), dict(t_c0=1.0),
                                     dict(branch_after=3)])
    def test_profile_validation_matches(self, bad):
        def build(pkg):
            t_c = np.array([bad.get("t_c0", 0.0), 0.1, 0.2, 0.3])
            return pkg.CostProfile(
                t_c=t_c, alpha=np.ones(4),
                branches=(pkg.BranchSpec(bad.get("branch_after", 1), 0.5),),
                gamma=bad.get("gamma", 2.0), network=pkg.NetworkProfile("n", 1e6))
        with pytest.raises(ValueError) as ej:
            build(J)
        with pytest.raises(ValueError) as et:
            build(T)
        assert str(et.value) == str(ej.value)


# ------------------------------------------------- closed form / Dijkstra
class TestShortestPath:
    def test_closed_form_cases_identical(self):
        cases = [
            ([0.01, 0.02, 0.03, 0.04], [1e6, 2e5, 5e4, 1e5, 4e3], [], [], 10.0, 1e7),
            ([0.02, 0.05, 0.04], [6e5, 1e5, 3e4, 1e3], [1], [0.7], 100.0, 5.85e6),
            ([0.01, 0.9, 0.9], [1e6, 1e4, 1e4, 1e3], [1], [1.0], 1.0, 1e6),
            ([0.01, 0.02], [1e5, 1e4, 1e3], [1], [0.0], 10.0, 5.85e6),
        ]
        for t_c, alpha, pos, probs, gamma, bw in cases:
            jp, tp = profiles(t_c, alpha, pos, probs, gamma=gamma, bw=bw)
            np.testing.assert_array_equal(T.expected_time_all_splits(tp),
                                          J.expected_time_all_splits(jp))
            for s in range(len(t_c) + 1):
                assert T.expected_time(tp, s) == J.expected_time(jp, s)

    def test_graph_and_plans_identical(self):
        rng = np.random.default_rng(0)
        for _ in range(20):
            jp, tp = random_profiles(rng)
            assert T.build_partition_graph(tp).adj == J.build_partition_graph(jp).adj
            assert T.dijkstra(T.build_partition_graph(tp)) == \
                J.dijkstra(J.build_partition_graph(jp))
            same_plan(T.shortest_path_plan(tp), J.shortest_path_plan(jp))
            same_plan(T.brute_force_split(tp), J.brute_force_split(jp))

    @settings(max_examples=100, deadline=None)
    @given(n=st.integers(2, 10), data=st.data())
    def test_property_dijkstra_plans_identical(self, n, data):
        t_c = data.draw(st.lists(st.floats(1e-4, 1.0), min_size=n, max_size=n))
        alpha = data.draw(st.lists(st.floats(1.0, 1e7), min_size=n + 1,
                                   max_size=n + 1))
        k = data.draw(st.integers(0, n - 1))
        pos = data.draw(st.lists(st.integers(1, n - 1), min_size=k, max_size=k,
                                 unique=True))
        probs = data.draw(st.lists(st.floats(0.0, 1.0), min_size=k, max_size=k))
        gamma = data.draw(st.floats(1.0, 1e4))
        bw = data.draw(st.floats(1e5, 1e10))
        jp, tp = profiles(t_c, alpha, sorted(pos), probs, gamma=gamma, bw=bw)
        plan = T.shortest_path_plan(tp)
        same_plan(plan, J.shortest_path_plan(jp))
        assert plan.expected_time_s == pytest.approx(
            T.brute_force_split(tp).expected_time_s, rel=1e-9, abs=1e-12)

    def test_branch_compute_identical(self):
        jp, tp = profiles([0.01, 0.02, 0.03], [1e6, 1e5, 1e4, 1e3], [1], [0.5],
                          include_bc=True, bc=[0.005])
        np.testing.assert_array_equal(T.expected_time_all_splits(tp),
                                      J.expected_time_all_splits(jp))


def chain_inputs(rng, n):
    t_c = np.concatenate([[0.0], rng.uniform(1e-3, 1e-1, n)])
    alpha = rng.uniform(1e3, 1e6, n + 1)
    p = np.zeros(n + 1)
    for i in rng.choice(np.arange(1, n), size=min(3, n - 1), replace=False):
        p[i] = rng.uniform(0, 1)
    return t_c, alpha, p


class TestTorchChainSolver:
    def test_float64_matches_numpy_closed_form(self):
        rng = np.random.default_rng(1)
        for _ in range(10):
            n = int(rng.integers(2, 12))
            t_c, alpha, p = chain_inputs(rng, n)
            gamma, bw = 50.0, 5.85e6
            pos = [i for i in range(1, n) if p[i] > 0]
            _, tp = profiles(t_c[1:], alpha, pos, [p[i] for i in pos], gamma, bw)
            got = T.chain_costs_torch(*(torch.tensor(a, dtype=F64)
                                        for a in (t_c, alpha, p, gamma, bw)))
            assert got.dtype == F64
            np.testing.assert_allclose(got.numpy(), T.expected_time_all_splits(tp),
                                       rtol=1e-12, atol=0)
            s, cost = T.solve_chain_torch(*(torch.tensor(a, dtype=F64)
                                            for a in (t_c, alpha, p, gamma, bw)))
            plan = T.brute_force_split(tp)
            assert int(s) == plan.split_layer
            assert float(cost) == pytest.approx(plan.expected_time_s, rel=1e-12)

    def test_branch_head_term_matches_closed_form(self):
        rng = np.random.default_rng(4)
        t_c, alpha, p = chain_inputs(rng, 8)
        bc = np.where(p > 0, 0.004, 0.0)
        pos = [i for i in range(1, 8) if p[i] > 0]
        _, tp = profiles(t_c[1:], alpha, pos, [p[i] for i in pos], 20.0, 1e7,
                         include_bc=True, bc=[bc[i] for i in pos])
        got = T.chain_costs_torch(*(torch.tensor(a, dtype=F64) for a in
                                    (t_c, alpha, p, 20.0, 1e7)),
                                  branch_t_c=torch.tensor(bc, dtype=F64))
        np.testing.assert_allclose(got.numpy(), T.expected_time_all_splits(tp),
                                   rtol=1e-12, atol=0)

    def test_float32_matches_jax(self):
        rng = np.random.default_rng(2)
        for _ in range(5):
            t_c, alpha, p = chain_inputs(rng, int(rng.integers(2, 12)))
            args = (t_c, alpha, p, 50.0, 5.85e6)
            got = T.chain_costs_torch(*(torch.tensor(a, dtype=torch.float32)
                                        for a in args))
            want = J.chain_costs_jax(*(jnp.asarray(a, jnp.float32) for a in args))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)

    def test_float32_gradients_match_jax_grad(self):
        rng = np.random.default_rng(3)
        t_c, alpha, p = chain_inputs(rng, 6)
        args = [t_c, alpha, p, 50.0, 5.85e6]
        w = rng.uniform(0.5, 1.5, len(t_c))

        def jloss(*a):
            return jnp.sum(jnp.asarray(w, jnp.float32) * J.chain_costs_jax(*a))

        jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
            *(jnp.asarray(a, jnp.float32) for a in args))
        tt = [torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in args]
        (torch.tensor(w, dtype=torch.float32) * T.chain_costs_torch(*tt)).sum().backward()
        for a, g in zip(tt, jg):
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(g), rtol=1e-5,
                                       atol=1e-12)

    def test_float64_gradients_match_finite_differences(self):
        rng = np.random.default_rng(5)
        t_c, alpha, p = chain_inputs(rng, 6)
        args = [torch.tensor(a, dtype=F64, requires_grad=True)
                for a in (t_c, alpha, p, 30.0, 2e6)]
        w = torch.tensor(rng.uniform(0.5, 1.5, len(t_c)), dtype=F64)

        def loss(*a):
            return (w * T.chain_costs_torch(*a)).sum()

        loss(*args).backward()
        for k, a in enumerate(args):
            flat = a.detach().reshape(-1)
            for i in range(flat.numel()):
                if k == 0 and i == 0:
                    continue  # t_c[0] is the virtual input layer
                h = 1e-6 * max(abs(float(flat[i])), 1e-3)
                up = [x.detach().clone() for x in args]
                dn = [x.detach().clone() for x in args]
                up[k].reshape(-1)[i] += h
                dn[k].reshape(-1)[i] -= h
                fd = (float(loss(*up)) - float(loss(*dn))) / (2 * h)
                assert float(a.grad.reshape(-1)[i]) == pytest.approx(fd, rel=1e-6,
                                                                     abs=1e-12)

    def test_vmapped_sweep_equals_brute_force_per_point(self):
        rng = np.random.default_rng(6)
        t_c, alpha, p = chain_inputs(rng, 10)
        pos = [i for i in range(1, 10) if p[i] > 0]
        _, tp = profiles(t_c[1:], alpha, pos, [p[i] for i in pos], 25.0, 1e6)
        bws = np.logspace(4, 10, 64)
        base = [torch.tensor(a, dtype=F64) for a in (t_c, alpha, p, 25.0)]
        sweep = torch.func.vmap(T.solve_chain_torch, in_dims=(None,) * 4 + (0,))
        s, cost = sweep(*base, torch.tensor(bws, dtype=F64))
        s_b, cost_b = T.solve_chain_torch(*base, torch.tensor(bws, dtype=F64))
        assert torch.equal(s, s_b) and torch.equal(cost, cost_b)
        for i, bw in enumerate(bws):
            plan = T.brute_force_split(dataclasses.replace(
                tp, network=T.NetworkProfile("sweep", float(bw))))
            assert int(s[i]) == plan.split_layer
            assert float(cost[i]) == pytest.approx(plan.expected_time_s, rel=1e-12)
        assert len(set(s.tolist())) > 1  # the sweep crosses split changes


# ------------------------------------------------------------- partitioner
class TestPartitioner:
    def costs(self, pkg):
        return [pkg.LayerCost(f"block{i}", 0.0, 0.0, 512.0 * i, 1e-3 * i)
                for i in range(1, 6)]

    @pytest.mark.parametrize("network", ["3g", "4g", "wifi"])
    def test_build_solve_and_modifiers_identical(self, network):
        jp = J.build_cost_profile(self.costs(J), (1, 3), [0.4, 0.2], network,
                                  25.0, 32 * 1024.0)
        tp = T.build_cost_profile(self.costs(T), (1, 3), [0.4, 0.2], network,
                                  25.0, 32 * 1024.0)
        np.testing.assert_array_equal(tp.t_c, jp.t_c)
        np.testing.assert_array_equal(tp.alpha, jp.alpha)
        assert tp.layer_names == jp.layer_names
        for method in ("dijkstra", "brute_force"):
            pj, pt = J.Partitioner(jp, method), T.Partitioner(tp, method)
            same_plan(pt.solve(), pj.solve())
            np.testing.assert_array_equal(pt.all_split_times(), pj.all_split_times())
            same_plan(pt.with_gamma(1000.0).solve(), pj.with_gamma(1000.0).solve())
            same_plan(pt.with_exit_probs([1.0, 0.0]).solve(),
                      pj.with_exit_probs([1.0, 0.0]).solve())
            same_plan(pt.with_network("wifi").solve(), pj.with_network("wifi").solve())

    def test_calibration_result_feeds_profile(self):
        ents = np.random.default_rng(0).uniform(0, 1, (2, 64))
        jp = J.build_cost_profile(self.costs(J), (1, 3),
                                  J.calibrate_exit_probs(ents, 0.4), "4g", 25.0, 1e4)
        tp = T.build_cost_profile(self.costs(T), (1, 3),
                                  T.calibrate_exit_probs(ents, 0.4), "4g", 25.0, 1e4)
        np.testing.assert_array_equal(tp.branch_exit_probs(), jp.branch_exit_probs())
        with pytest.raises(ValueError):
            T.build_cost_profile(self.costs(T), (1, 3), [0.5], "4g", 25.0, 1e4)


# -------------------------------------------------------------------- DAG
class TestDag:
    @settings(max_examples=60, deadline=None)
    @given(n=st.integers(2, 10), gamma=st.floats(1.0, 500.0),
           bw=st.floats(1e5, 1e9), seed=st.integers(0, 2**16))
    def test_chain_mincut_identical(self, n, gamma, bw, seed):
        rng = np.random.default_rng(seed)
        t_c = np.concatenate([[0.0], rng.uniform(1e-4, 1e-1, n)])
        alpha = rng.uniform(1e2, 1e6, n + 1)
        got = T.min_cut_partition(T.chain_as_dag(t_c, alpha, bw, gamma))
        assert got == J.min_cut_partition(J.chain_as_dag(t_c, alpha, bw, gamma))
        sp = T.brute_force_split(T.CostProfile(
            t_c=t_c, alpha=alpha, branches=(), gamma=gamma,
            network=T.NetworkProfile("t", bw)))
        assert got[2] == pytest.approx(sp.expected_time_s, rel=1e-6, abs=1e-9)
        assert len(got[0]) == sp.split_layer

    @pytest.mark.parametrize("bw", [1e10, 1e3, 2e8])
    def test_diamond_identical(self, bw):
        def build(mod):
            nodes = {n: mod.DagNode(n, te, tc) for n, te, tc in (
                ("a", 10e-3, 1e-3), ("b", 50e-3, 5e-3), ("c", 50e-3, 5e-3),
                ("d", 20e-3, 2e-3))}
            tx = 1e6 * 8 / bw
            links = [("a", "b", tx), ("a", "c", tx), ("b", "d", tx), ("c", "d", tx)]
            return mod.DagCostModel(nodes, links, input_upload_time=4e6 * 8 / bw,
                                    input_consumers=("a",))
        assert tdag.min_cut_partition(build(tdag)) == jdag.min_cut_partition(build(jdag))

    def test_random_dag_identical(self):
        rng = np.random.default_rng(3)
        names = ["a", "b", "c", "d", "e"]
        node_t = [(float(rng.uniform(1e-3, 1e-1)), float(rng.uniform(1e-4, 1e-2)))
                  for _ in names]
        links = [(u, v, float(rng.uniform(1e-4, 5e-2))) for u, v in
                 (("a", "b"), ("a", "c"), ("b", "d"), ("c", "d"), ("d", "e"))]

        def build(mod):
            nodes = {n: mod.DagNode(n, *t) for n, t in zip(names, node_t)}
            return mod.DagCostModel(nodes, list(links), input_upload_time=0.05,
                                    input_consumers=("a",))
        assert tdag.min_cut_partition(build(tdag)) == jdag.min_cut_partition(build(jdag))


# -------------------------------------------------------------- multitier
def random_chain(rng, n, with_branches=True):
    t_c = np.concatenate([[0.0], rng.uniform(1e-4, 1e-1, n)])
    alpha = rng.uniform(1e2, 1e6, n + 1)
    p = np.zeros(n + 1)
    if with_branches and n > 2:
        for i in rng.choice(np.arange(1, n), size=min(2, n - 1), replace=False):
            p[i] = rng.uniform(0, 1)
    return t_c, alpha, p


def tiers_both(*specs):
    return ([jmt.TierSpec(*s[:3], **s[3]) if len(s) > 3 else jmt.TierSpec(*s)
             for s in specs],
            [tmt.TierSpec(*s[:3], **s[3]) if len(s) > 3 else tmt.TierSpec(*s)
             for s in specs])


class TestMultitier:
    def test_tierspec_converts_either_way(self):
        spec = tmt.TierSpec("edge", 12.0, 1.1e6, devices=2, ici_bps=3.6e12,
                            availability=0.9)
        back = jmt.TierSpec(**dataclasses.asdict(spec))
        assert tmt.TierSpec(**dataclasses.asdict(back)) == spec

    def test_bucket_ladder_identical(self):
        for b in range(1, 40):
            assert tmt.bucket_ladder(b) == jmt.bucket_ladder(b)
            assert [tmt.bucket_for(n, b) for n in range(b + 2)] == \
                [jmt.bucket_for(n, b) for n in range(b + 2)]

    @settings(max_examples=80, deadline=None)
    @given(n=st.integers(2, 12), seed=st.integers(0, 2**16),
           gamma=st.floats(1.0, 1000.0), bw=st.floats(1e5, 1e9))
    def test_two_tier_identical_and_matches_paper(self, n, seed, gamma, bw):
        rng = np.random.default_rng(seed)
        t_c, alpha, p = random_chain(rng, n)
        jt, tt = tiers_both(("edge", gamma, bw), ("cloud", 1.0))
        plan = tmt.solve_multitier(t_c, alpha, p, tt)
        assert dataclasses.astuple(plan) == dataclasses.astuple(
            jmt.solve_multitier(t_c, alpha, p, jt))
        prof = T.CostProfile(
            t_c=t_c, alpha=alpha, gamma=gamma, network=T.NetworkProfile("t", bw),
            branches=tuple(T.BranchSpec(i, float(p[i])) for i in range(1, n) if p[i] > 0))
        assert plan.cut_after == (T.brute_force_split(prof).split_layer,)

    @settings(max_examples=40, deadline=None)
    @given(n=st.integers(2, 8), seed=st.integers(0, 2**16))
    def test_three_tier_identical(self, n, seed):
        rng = np.random.default_rng(seed)
        t_c, alpha, p = random_chain(rng, n)
        jt, tt = tiers_both(("device", 200.0, 1e6), ("edge", 20.0, 2e7), ("cloud", 1.0))
        plan = tmt.solve_multitier(t_c, alpha, p, tt)
        assert dataclasses.astuple(plan) == dataclasses.astuple(
            jmt.solve_multitier(t_c, alpha, p, jt))
        assert all(a <= b for a, b in zip(plan.tier_of_layer, plan.tier_of_layer[1:]))

    @pytest.mark.parametrize("variant", [
        dict(batch=8), dict(batch=8, occupancy=0.5), dict(overlap=True),
        dict(batch=16, overlap=True), dict(heads=True), dict(heads=True, batch=8),
        dict(sharded=True), dict(availability=0.5)])
    def test_solver_variants_identical(self, variant):
        rng = np.random.default_rng(7)
        t_c, alpha, p = random_chain(rng, 9)
        kw = {k: v for k, v in variant.items() if k in ("batch", "occupancy", "overlap")}
        extra = {}
        if variant.get("sharded"):
            extra = dict(devices=4, ici_bps=3.6e12)
        avail = dict(availability=variant.get("availability", 1.0))
        jt, tt = tiers_both(("device", 60.0, 18.8e6, avail), ("edge", 12.0, 1.1e6, extra),
                            ("cloud", 1.0))
        if variant.get("heads"):
            kw["branch_layers"] = (2, 5)
            p[2], p[5] = 0.3, 0.4
        cfg = ModelConfig(name="t", arch_type="dense", source="t", d_model=256,
                          vocab_size=512)
        hw = dict(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9, hbm_bytes=80e9)
        b = kw.get("batch", 8)
        jk = dict(kw, head_cost=jprof.branch_head_cost(
            cfg, b, hardware=jprof.HardwareSpec("h", **hw))) if variant.get("heads") else kw
        tk = dict(kw, head_cost=tprof.branch_head_cost(
            cfg, b, hardware=tprof.HardwareSpec("h", **hw))) if variant.get("heads") else kw
        plan = tmt.solve_multitier(t_c, alpha, p, tt, **tk)
        assert dataclasses.astuple(plan) == dataclasses.astuple(
            jmt.solve_multitier(t_c, alpha, p, jt, **jk))
        for cuts in ((0, 0), (2, 5), (3, 9), (9, 9), plan.cut_after):
            assert tmt.expected_time_multitier(t_c, alpha, p, tt, cuts, **tk) == \
                jmt.expected_time_multitier(t_c, alpha, p, jt, cuts, **jk)

    def test_from_cost_profile_and_errors_identical(self):
        jp, tp = profiles([0.01, 0.02, 0.03], [1e6, 1e5, 1e4, 1e3], [1], [0.5])
        jt, tt = tiers_both(("edge", 10.0, 5.85e6), ("cloud", 1.0))
        assert dataclasses.astuple(tmt.from_cost_profile(tp, tt)) == \
            dataclasses.astuple(jmt.from_cost_profile(jp, jt))
        jd, td = tiers_both(("a", 2.0, 0.0), ("b", 1.0))
        t_c, alpha, p = jp.t_c, jp.alpha, jp.branch_exit_probs()
        for kw in (dict(), dict(batch=4)):
            t_plan = tmt.solve_multitier(t_c, alpha, p, td, **kw)
            assert dataclasses.astuple(t_plan) == dataclasses.astuple(
                jmt.solve_multitier(t_c, alpha, p, jd, **kw))
        with pytest.raises(ValueError) as ej:
            jmt.expected_time_multitier(t_c, alpha, p, jt, (1, 2))
        with pytest.raises(ValueError) as et:
            tmt.expected_time_multitier(t_c, alpha, p, tt, (1, 2))
        assert str(et.value) == str(ej.value)


# ------------------------------------------------------------ calibration
class TestCalibration:
    @settings(max_examples=50, deadline=None)
    @given(k=st.integers(1, 4), b=st.integers(1, 64), thr=st.floats(0.05, 0.95),
           seed=st.integers(0, 2**16))
    def test_calibration_identical(self, k, b, thr, seed):
        ents = np.random.default_rng(seed).uniform(0, 1, (k, b))
        got, want = T.calibrate_exit_probs(ents, thr), J.calibrate_exit_probs(ents, thr)
        for f in ("conditional_p", "unconditional_p", "exit_fraction", "survival"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert got.threshold == want.threshold
        assert got.exit_fraction.sum() == pytest.approx(1.0)

    def test_threshold_sweep_identical(self):
        ents = np.random.default_rng(1).uniform(0, 1, (2, 400))
        thr = np.linspace(0.1, 0.9, 9)
        got = T.threshold_sweep(ents, thr)
        np.testing.assert_array_equal(got, J.threshold_sweep(ents, thr))
        assert np.all(np.diff(got[:, 0]) >= -1e-12)

    def test_exit_mask_matches_reference(self):
        logits = np.random.default_rng(2).normal(size=(6, 300)).astype(np.float32) * 3
        logits[0, 7] = 40.0
        ht = T.normalized_entropy(torch.from_numpy(logits)).numpy()
        hj = np.asarray(J.normalized_entropy(jnp.asarray(logits)))
        np.testing.assert_allclose(ht, hj, rtol=0, atol=1e-6)
        thr = float(np.median(hj))
        far = np.abs(hj - thr) > 1e-5
        mt = T.exit_mask(torch.from_numpy(logits), thr).numpy()
        mj = np.asarray(J.exit_mask(jnp.asarray(logits), thr))
        np.testing.assert_array_equal(mt[far], mj[far])
        assert mt[0]


# --------------------------------------------------------------- profiler
H100_VALUES = dict(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9, hbm_bytes=80e9)


def _fixture_cfgs():
    jcfg = dataclasses.replace(get_smoke_config("phi3_mini_3_8b"), num_layers=4,
                               branch_layers=(1, 3), dtype="float32")
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def fixture_weights():
    jcfg, _ = _fixture_cfgs()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


class TestProfiler:
    def test_h100_spec(self):
        assert dataclasses.asdict(T.H100_SXM) == dict(name="h100-sxm", **H100_VALUES)
        assert not hasattr(tprof, "TPU_V5E")
        with pytest.raises(TypeError):
            tprof.HardwareSpec("no-defaults", 1e12, 1e12)  # link_bw, hbm_bytes required

    @pytest.mark.parametrize("devices", [1, 4])
    def test_roofline_and_collective_match_reference(self, devices):
        t = tprof.HardwareSpec("h", **H100_VALUES)
        j = jprof.HardwareSpec("h", **H100_VALUES)
        for flops, nbytes in ((1e12, 1e6), (1e6, 1e12), (0.0, 0.0)):
            assert t.roofline_time(flops, nbytes, devices) == \
                j.roofline_time(flops, nbytes, devices)
        assert t.collective_time(1e6, devices) == j.collective_time(1e6, devices)

    @pytest.mark.parametrize("heads_batched", [True, False])
    @pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
    def test_branch_head_cost_matches_reference(self, heads_batched, dtype):
        jcfg = dataclasses.replace(get_smoke_config("phi3_mini_3_8b"), dtype=dtype)
        tcfg = ModelConfig(**dataclasses.asdict(jcfg))
        got = tprof.branch_head_cost(tcfg, 8, heads_batched=heads_batched)
        want = jprof.branch_head_cost(jcfg, 8, heads_batched=heads_batched,
                                      hardware=jprof.HardwareSpec("h", **H100_VALUES))
        assert [got(m) for m in range(5)] == [want(m) for m in range(5)]

    def test_analyze_counts_against_closed_form_and_xla(self, fixture_weights):
        jp, tp = fixture_weights
        jcfg, tcfg = _fixture_cfgs()
        b, c = 2, 16
        got = T.profile_decode_layers(tcfg, tp, b, c, mode="analyze")
        xla = J.profile_decode_layers(jcfg, jp, b, c, use_kernels=False, mode="analyze")
        d, h, kh, hd = tcfg.d_model, tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim
        weights = d * h * hd * 2 + 2 * d * kh * hd + 3 * d * tcfg.d_ff
        flops = 2 * b * weights + 4 * b * h * c * hd
        floor = (weights + 2 * d) * 4 + 2 * b * c * kh * hd * 4 + b * c * 4 + 2 * b * d * 4
        assert len(got) == tcfg.num_layers
        for t, x in zip(got, xla):
            assert t.flops == flops
            assert t.flops == pytest.approx(x.flops, rel=0.01)
            assert t.bytes_accessed >= floor
            assert t.bytes_accessed == pytest.approx(x.bytes_accessed, rel=0.15)
            assert t.output_bytes == x.output_bytes == b * d * 4
            assert t.time_s == T.H100_SXM.roofline_time(t.flops, t.bytes_accessed)

    def test_measure_mode_times_every_layer(self, fixture_weights):
        _, tp = fixture_weights
        _, tcfg = _fixture_cfgs()
        got = T.profile_decode_layers(tcfg, tp, 2, 16, mode="measure", iters=2,
                                      warmup=1)
        assert [c.name for c in got] == [f"layer{i}" for i in range(1, 5)]
        assert all(c.time_s > 0 and c.output_bytes == 2 * tcfg.d_model * 4
                   for c in got)

    def test_measure_mode_on_cuda_raises_when_capture_fails(self, monkeypatch):
        """CUDA inputs are timed as graph replays only: a capture that fails
        raises, and the layer is never timed eagerly instead."""
        calls = []

        def refuse(fn, args, warmup):
            raise RuntimeError("operation not permitted when stream is capturing")

        # The layer's input reads as a CUDA tensor; this build has no CUDA.
        monkeypatch.setattr(tprof, "_tensors", lambda tree: iter(
            [types.SimpleNamespace(device=torch.device("cuda", 0))]))
        monkeypatch.setattr(tprof, "capture_layer", refuse)
        with pytest.raises(RuntimeError, match="capturing layer1 as a CUDA graph failed"):
            tprof.measure_layer_times([("layer1", calls.append)], [None], iters=2, warmup=1)
        assert calls == []

    def test_profile_feeds_the_partitioner(self, fixture_weights):
        _, tp = fixture_weights
        _, tcfg = _fixture_cfgs()
        costs = T.profile_decode_layers(tcfg, tp, 2, 16, mode="analyze")
        prof = T.build_cost_profile(costs, tcfg.branch_layers, [0.5, 0.5], "4g",
                                    25.0, 32 * 1024.0)
        plan = T.Partitioner(prof).solve()
        assert plan.split_layer == T.brute_force_split(prof).split_layer

    def test_ring_fill_and_unsupported_requests(self, fixture_weights):
        _, tp = fixture_weights
        _, tcfg = _fixture_cfgs()
        _, inputs = T.decode_layer_fns(tcfg, tp, 2, 16, pos=5)
        kv = inputs[0][1]["blocks"]["self"]
        assert kv["pos"][:, :, :5].eq(torch.arange(5)).all()
        assert kv["pos"][:, :, 5:].eq(-1).all() and kv["length"].eq(5).all()
        # A sharded tier (devices > 1) is priced, no longer refused: the
        # devices=1 costs over the shard width plus the collective term,
        # as the reference prices it.
        one = T.profile_decode_layers(tcfg, tp, 2, 16)
        two = T.profile_decode_layers(tcfg, tp, 2, 16, devices=2)
        for o, t in zip(one, two):
            assert (t.flops, t.bytes_accessed, t.output_bytes) == (
                o.flops, o.bytes_accessed, o.output_bytes)
            assert t.time_s == pytest.approx(
                o.time_s / 2 + T.H100_SXM.collective_time(o.output_bytes, 2), rel=1e-12)
        with pytest.raises(ValueError, match="mode"):
            T.profile_decode_layers(tcfg, tp, 2, 16, mode="guess")

