"""The port's serving path on Mamba2 (``ssm``) and Zamba2 (``hybrid``)
trunks against the reference ``PartitionedServer`` on the CPU, on bridged
weights, and the port's own invariants on those trunks.

Fixtures: the ``mamba2_130m`` and ``zamba2_1_2b`` smoke configs with
``num_layers=4, branch_layers=(1, 3)`` (and ``attn_every=2`` for Zamba2,
so shared-attention sites sit after layers 2 and 4), split after layer 2:
the edge keeps branch 1 (and site 2), branch 3 sits in the final tier and
is not evaluated.

Cross-framework trajectories are compared in fp32 compute, where logits
agree to ~1e-6: tokens, exit masks, shipped rows, bytes and compaction
buckets must then be equal step after step.  The threshold sits between
the 4th and 5th smallest branch-1 entropies of the first step, so rows
exit on the edge and the cloud runs compacted buckets.  Invariants inside
the port (the overflow re-run, a recycled slot, ``reset_rows``) are exact
in bf16.
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
from repro_torch import bridge
from repro_torch.configs import ModelConfig
from repro_torch.models import model as TM
from repro_torch.serving import PartitionedServer, TierExecutor, segments_for_cuts

SPLIT = 2
ARCHS = ["mamba2_130m", "zamba2_1_2b"]


def _cfgs(arch, dtype, thr=0.5):
    kw = dict(num_layers=4, branch_layers=(1, 3), dtype=dtype, exit_threshold=thr)
    if arch == "zamba2_1_2b":
        kw["attn_every"] = 2
    jcfg = dataclasses.replace(get_smoke_config(arch), **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _tokens(batch=8, seed=1):
    return np.random.default_rng(seed).integers(0, 512, (batch, 1)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(arch, reference params, port params, mixed threshold)."""
    arch = request.param
    jcfg, tcfg = _cfgs(arch, "float32")
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    ts = PartitionedServer(tcfg, tp, SPLIT, device="cpu")
    rep, _ = ts.step(torch.from_numpy(_tokens()), 0,
                     TM.init_caches(tcfg, 8, 32, device="cpu"))
    e = np.sort(rep.tier_result.branch_entropy[1])
    return arch, jp, tp, float((e[3] + e[4]) / 2)


def _hops(rep):
    return [(c.survivors, c.bucket) for c in rep.compaction]


class TestPartitionedParity:
    @pytest.mark.parametrize("compaction,heads_batched", [
        ("bucketed", True), ("bucketed", False), ("off", True), ("off", False)])
    def test_trajectory_matches_reference(self, model, compaction, heads_batched):
        arch, jp, tp, thr = model
        jcfg, tcfg = _cfgs(arch, "float32", thr)
        js = JaxServer(jcfg, jp, SPLIT, compaction=compaction,
                       heads_batched=heads_batched, use_kernels=False)
        ts = PartitionedServer(tcfg, tp, SPLIT, compaction=compaction,
                               heads_batched=heads_batched, device="cpu")
        jc, tc = JM.init_caches(jcfg, 8, 32), TM.init_caches(tcfg, 8, 32, device="cpu")
        jt, tt = jnp.asarray(_tokens()), torch.from_numpy(_tokens())
        steps = 3
        exits = 0
        for i in range(steps):
            jr, jc = js.step(jt, i, jc)
            tr, tc = ts.step(tt, i, tc)
            np.testing.assert_array_equal(tr.tokens, jr.tokens)
            np.testing.assert_array_equal(tr.exited_on_edge, jr.exited_on_edge)
            assert (tr.shipped, tr.bytes_shipped, _hops(tr)) == \
                (jr.shipped, jr.bytes_shipped, _hops(jr))
            assert tr.branch_take.keys() == jr.branch_take.keys() == {1}
            np.testing.assert_array_equal(tr.branch_take[1], jr.branch_take[1])
            exits += int(tr.exited_on_edge.sum())
            jt = jr.tier_result.tokens_dev[:, None]
            tt = tr.tier_result.tokens_dev[:, None]
        assert exits > 0
        assert ts.executor.overflow_retries == js.executor.overflow_retries
        assert ts.executor.host_syncs == steps + ts.executor.overflow_retries
        jn, tn = jax.tree.map(np.asarray, jc), bridge.caches_to_numpy(tc)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(tn["blocks"]["self"][k], jn["blocks"]["self"][k],
                                       rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tn["blocks"]["self"]["length"],
                                      jn["blocks"]["self"]["length"])
        if arch == "zamba2_1_2b":
            np.testing.assert_array_equal(tn["shared_attn"]["self"]["pos"],
                                          jn["shared_attn"]["self"]["pos"])

    def test_requests_match_reference(self, model):
        """Continuous batching over 4 slots: two prompt lengths, budgets
        that retire at different steps, recycled slots."""
        arch, jp, tp, thr = model
        jcfg, tcfg = _cfgs(arch, "float32", thr)
        js = JaxServer(jcfg, jp, SPLIT, use_kernels=False, slots=4, context_len=32)
        ts = PartitionedServer(tcfg, tp, SPLIT, device="cpu", slots=4, context_len=32)
        rng = np.random.default_rng(5)
        for plen, budget in [(5, 3), (5, 2), (7, 2), (5, 2), (7, 2)]:
            prompt = rng.integers(0, 512, plen)
            assert js.submit(prompt, budget) == ts.submit(prompt, budget)
        jres, tres = js.drain(), ts.drain()
        assert [r.rid for r in tres] == [r.rid for r in jres]
        for a, b in zip(tres, jres):
            assert (a.tokens, a.exited, a.exit_tiers, a.slot) == \
                (b.tokens, b.exited, b.exit_tiers, b.slot)
        ex = ts.executor
        assert ex.host_syncs == ts.scheduler.decode_steps + ex.overflow_retries


class TestPortInvariants:
    """Exact inside the port, in bf16."""

    def _run(self, tcfg, tp, steps, hints=None):
        """``hints``: the cloud bucket planned at each step (1 forces an
        overflow re-run whenever more than one row survives)."""
        ex = TierExecutor(tcfg, tp, segments_for_cuts(tcfg, (SPLIT,)), device="cpu")
        caches = TM.init_caches(tcfg, 8, 32, device="cpu")
        tok = torch.from_numpy(_tokens())
        out = []
        for i in range(steps):
            if hints is not None:
                ex._hints = {1: hints[i]}
            res, caches = ex.step(tok, i, caches)
            out.append(res)
            tok = res.tokens_dev[:, None]
        return ex, out, caches

    def test_overflow_rerun_restores_state_bitwise(self, model):
        """A re-run restores every Mamba2 conv window and SSM state (and,
        for Zamba2, the shared-attention ring slots) bitwise: the
        trajectory and the final caches equal a run planned with the same
        buckets that never overflowed (fp32 state is sensitive to the
        sub-batch width a matmul runs at, so the widths must match)."""
        arch, _, tp, thr = model
        tcfg = _cfgs(arch, "bfloat16", thr)[1]
        exb, outb, cb = self._run(tcfg, tp, 3, hints=[1, 1, 1])
        used = [r.compaction[0].bucket for r in outb]
        exa, outa, ca = self._run(tcfg, tp, 3, hints=used)
        assert exa.overflow_retries == 0 < exb.overflow_retries
        assert exb.host_syncs == 3 + exb.overflow_retries
        for a, b in zip(outa, outb):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            np.testing.assert_array_equal(a.exited, b.exited)
        flat_a, flat_b = bridge.caches_to_numpy(ca), bridge.caches_to_numpy(cb)
        jax.tree.map(np.testing.assert_array_equal, flat_a, flat_b)

    def test_recycled_slot_matches_solo(self, model):
        """A request admitted into a recycled slot mid-flight decodes
        exactly as it does alone: its conv window and SSM state come from
        the row-targeted admission scan, not the previous occupant."""
        arch, _, tp, thr = model
        tcfg = _cfgs(arch, "bfloat16", thr)[1]
        target = np.random.default_rng(9).integers(0, 512, 6).astype(np.int32)

        def serve(fill):
            srv = PartitionedServer(tcfg, tp, SPLIT, device="cpu", slots=4,
                                    context_len=64)
            if fill:
                rng = np.random.default_rng(5)
                for plen, budget in [(4, 3)] * 6 + [(6, 4)] * 2:
                    srv.submit(rng.integers(0, 512, plen).astype(np.int32), budget)
            rid = srv.submit(target, 4)
            srv.drain()
            return srv.scheduler.results[rid]

        solo, rec = serve(False), serve(True)
        assert rec.admitted_step > 0
        assert (rec.tokens, rec.exited, rec.exit_tiers) == \
            (solo.tokens, solo.exited, solo.exit_tiers)

    def test_reset_rows_zeroes_state(self, model):
        arch, _, tp, thr = model
        tcfg = _cfgs(arch, "bfloat16", thr)[1]
        ex, _, caches = self._run(tcfg, tp, 2)
        before = jax.tree.map(np.copy, bridge.caches_to_numpy(caches))
        ex.reset_rows(caches, np.array([1, 6, 8, 8]))  # two sentinels
        after = bridge.caches_to_numpy(caches)
        st, st0 = after["blocks"]["self"], before["blocks"]["self"]
        keep = [0, 2, 3, 4, 5, 7]
        for k in ("conv", "ssm"):
            np.testing.assert_array_equal(st[k][:, [1, 6]], 0)
            np.testing.assert_array_equal(st[k][:, keep], st0[k][:, keep])
            assert st0[k][:, [1, 6]].any()
        if arch == "zamba2_1_2b":
            pos, pos0 = after["shared_attn"]["self"]["pos"], before["shared_attn"]["self"]["pos"]
            np.testing.assert_array_equal(pos[:, [1, 6]], -1)
            np.testing.assert_array_equal(pos[:, keep], pos0[:, keep])
