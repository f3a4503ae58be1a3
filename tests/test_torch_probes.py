"""The port's segment cache and probe steps against the reference on the
CPU, on bridged weights.

  * the segment cache: the decode-segment keys the port builds and its
    ``trace_counts`` (builds per key) equal the reference's jit traces
    step by step through repartitions, a swap back, an overflow re-run and
    a switch from lock-step to per-row positions; an unchanged segment
    keeps its cached function; ``graphs=True`` on the CPU raises (graphs
    are CUDA's; the CPU and ``graphs=False`` run the cached entries
    eagerly);
  * probe steps (reference ``tests/test_kernel_runtime.py`` TestProbeSteps,
    ``test_scheduler.py`` TestSampledProbes, ``test_batched_heads.py``
    TestProbeParity): report-only extra heads — tokens, exits and caches
    bitwise those of a normal step inside the port — with probe masks and
    sampled-probe coverage equal to the reference's and entropies within
    1e-6 (fp32 compute).

The reference's kernel-path probe case (``test_kernel_runtime.py``'s
``test_probe_with_kernels``, Pallas in interpret mode) has no CPU
counterpart here: the port's kernels run only on the card, where
``chip_smoke.py``'s probe phase holds graphed probe steps bitwise against
normal steps.  Only the reference's decode-segment keys are compared: its
``trace_counts`` also counts prefill traces, which the port does not
cache (admission runs eagerly).  The reference's key also carries the
shard width, which waits for its slice.

Fixture: the ``phi3_mini_3_8b`` smoke config with ``num_layers=4,
branch_layers=(1, 3)`` in fp32 compute, the threshold at the midpoint of
the first step's branch entropies (a mixed exit regime), as in the
reference tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.multitier import TierSpec as JTierSpec
from repro.models import model as JM
from repro.serving import MultiTierServer as JMultiTierServer
from repro.serving import TierExecutor as JExecutor
from repro.serving import segments_for_cuts as jsegments
from repro_torch import bridge
from repro_torch.configs import ModelConfig
from repro_torch.core import TierSpec
from repro_torch.models import model as TM
from repro_torch.serving import (
    MultiTierServer,
    ServingEngine,
    TierExecutor,
    segments_for_cuts,
)

B = 8


def _cfgs(thr=0.5, branches=(1, 3)):
    jcfg = dataclasses.replace(get_smoke_config("phi3_mini_3_8b"), num_layers=4,
                               branch_layers=branches, dtype="float32",
                               exit_threshold=thr)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _toks(batch=B, seed=2):
    jcfg, _ = _cfgs()
    return np.array(jax.random.randint(jax.random.PRNGKey(seed), (batch, 1), 0,
                                       jcfg.vocab_size))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs(branches=(1, 2, 3))
    jp = jax.jit(JM.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    return jp, bridge.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _params(weights, branches):
    """Both packages' params for a branch layout (one scale row each)."""
    jp, tp = weights
    keep = [(1, 2, 3).index(b) for b in branches]
    jp = {**jp, "branches": {"scale": jp["branches"]["scale"][np.array(keep)]}}
    tp = {**tp, "branches": {"scale": tp["branches"]["scale"][keep]}}
    return jp, tp


@pytest.fixture(scope="module")
def mixed(weights):
    """Per branch layout: the midpoint of the K=1 step's branch entropies."""
    out = {}
    for branches in ((1, 3), (1, 2, 3)):
        jp, _ = _params(weights, branches)
        jcfg, _ = _cfgs(branches=branches)
        ex = JExecutor(jcfg, jp, jsegments(jcfg, ()), use_kernels=False)
        res, _ = ex.step(jnp.asarray(_toks()), 0, JM.init_caches(jcfg, B, 32))
        e = np.concatenate([res.branch_entropy[l] for l in branches])
        out[branches] = float((e.min() + e.max()) / 2)
    return out


def _pair(weights, mixed, cuts, branches=(1, 3), **kw):
    """A reference and a port executor on the same weights and plan."""
    jp, tp = _params(weights, branches)
    jcfg, tcfg = _cfgs(mixed[branches], branches)
    jex = JExecutor(jcfg, jp, jsegments(jcfg, cuts), use_kernels=False, **kw)
    tex = TierExecutor(tcfg, tp, segments_for_cuts(tcfg, cuts), device="cpu", **kw)
    return (jex, JM.init_caches(jcfg, B, 32)), (tex, TM.init_caches(tcfg, B, 32,
                                                                  device="cpu"))


def decode_keys(counts: dict) -> dict:
    """The reference's decode-segment trace counts under the port's key
    ``((lo, hi, branches, head, probe, probe_m, degrade), bucket)``."""
    out = {}
    for key, n in counts.items():
        if not isinstance(key[0], tuple):
            continue  # ("prefill", plen, n)
        (lo, hi, branches, head, devices, probe, probe_m, degrade), bucket = key
        assert devices == 1
        out[((lo, hi, branches, head, probe, probe_m, degrade), bucket)] = n
    return out


def _same_step(tr, jr, entropy=True):
    np.testing.assert_array_equal(tr.tokens, jr.tokens)
    np.testing.assert_array_equal(tr.exited, jr.exited)
    np.testing.assert_array_equal(tr.exit_tier, jr.exit_tier)
    assert tr.shipped_per_hop == jr.shipped_per_hop
    assert [(c.survivors, c.bucket) for c in tr.compaction] == \
        [(c.survivors, c.bucket) for c in jr.compaction]
    assert sorted(tr.branch_take) == sorted(jr.branch_take)
    for layer in jr.branch_take:
        np.testing.assert_array_equal(tr.branch_take[layer], jr.branch_take[layer])
        if entropy:
            np.testing.assert_allclose(tr.branch_entropy[layer],
                                       jr.branch_entropy[layer], rtol=0, atol=1e-6)
    assert sorted(tr.branch_probe_mask) == sorted(jr.branch_probe_mask)
    for layer, cover in jr.branch_probe_mask.items():
        np.testing.assert_array_equal(tr.branch_probe_mask[layer], cover)


class TestSegmentCache:
    def test_keys_and_trace_counts_match_reference(self, weights, mixed):
        """K=3 through a cut move, a swap back, a forced overflow re-run and
        per-row positions: after every step both packages hold the same
        decode keys with the same build counts, and each repartition reuses
        the cached function of every unchanged segment."""
        jp, tp = _params(weights, (1, 3))
        jcfg, tcfg = _cfgs(mixed[(1, 3)])
        jtiers = [JTierSpec("d", 100.0, 1e6), JTierSpec("e", 10.0, 1e7),
                  JTierSpec("c", 1.0)]
        tiers = [TierSpec("d", 100.0, 1e6), TierSpec("e", 10.0, 1e7),
                 TierSpec("c", 1.0)]
        js = JMultiTierServer(jcfg, jp, jtiers, (1, 3), use_kernels=False)
        ts = MultiTierServer(tcfg, tp, tiers, (1, 3), device="cpu")
        jc, tc = JM.init_caches(jcfg, B, 32), TM.init_caches(tcfg, B, 32, device="cpu")
        jt, tt = jnp.asarray(_toks()), torch.from_numpy(_toks())
        plan = [((1, 3), 0), ((2, 3), 1), ((1, 3), 2), ((2, 3), 3),
                ((2, 3), "overflow"), ((2, 3), "rows"), ((1, 3), "rows")]
        for i, (cuts, how) in enumerate(plan):
            js.install_cuts(cuts)
            ts.install_cuts(cuts)
            if how == "overflow":
                js.executor._hints = {1: 1, 2: 1}
                ts.executor._hints = {1: 1, 2: 1}
            pos = np.full(B, i, np.int32) if how == "rows" else i
            jr, jc = js.step(jt, pos, jc)
            tr, tc = ts.step(tt, pos, tc)
            _same_step(tr.tier_result, jr.tier_result)
            assert ts.executor.trace_counts == decode_keys(js.executor.trace_counts)
            jt = jr.tier_result.tokens_dev[:, None]
            tt = tr.tier_result.tokens_dev[:, None]
            if i == 0:
                first = dict(ts.executor._fn_cache)
        # Every function built at the first cuts, the cloud's too, is the
        # one still cached: no repartition rebuilt it.
        assert all(ts.executor._fn_cache[k] is f for k, f in first.items())
        assert ts.executor.overflow_retries == js.executor.overflow_retries >= 1
        assert ts.executor.host_syncs == len(plan) + ts.executor.overflow_retries
        # Per-row positions built a second variant of the keys they used.
        assert max(ts.executor.trace_counts.values()) == 2
        # A swap there and back builds nothing: each step finds its keys.
        cached, counts = dict(ts.executor._fn_cache), dict(ts.executor.trace_counts)
        for i, cuts in enumerate(((1, 3), (2, 3)), len(plan)):
            ts.install_cuts(cuts)
            _, tc = ts.step(tt, i, tc)
        assert ts.executor._fn_cache.keys() == cached.keys()
        assert all(ts.executor._fn_cache[k] is f for k, f in cached.items())
        assert ts.executor.trace_counts == counts

    def test_cpu_entries_are_eager(self, weights):
        _, tp = _params(weights, (1, 3))
        _, tcfg = _cfgs()
        ex = TierExecutor(tcfg, tp, segments_for_cuts(tcfg, (2,)), device="cpu")
        assert ex.graphs is False
        ex.step(torch.from_numpy(_toks()), 0, TM.init_caches(tcfg, B, 32, device="cpu"))
        built = [v for fn in ex._fn_cache.values() for v in fn.variants.values()]
        assert built and all(v is True for v in built)
        assert ex.replays == {}
        with pytest.raises(ValueError, match="graphs=True needs a CUDA device"):
            TierExecutor(tcfg, tp, segments_for_cuts(tcfg, (2,)), device="cpu",
                         graphs=True)

    def test_serving_engine_passes_graphs(self, weights):
        """``ServingEngine(graphs=...)`` reaches its executor: False is the
        eager engine anywhere, True on the CPU raises."""
        _, tp = _params(weights, (1, 3))
        _, tcfg = _cfgs()
        assert ServingEngine(tcfg, tp, context_len=32, device="cpu").executor.graphs is False
        eng = ServingEngine(tcfg, tp, context_len=32, device="cpu", graphs=False)
        assert eng.executor.graphs is False
        with pytest.raises(ValueError, match="graphs=True needs a CUDA device"):
            ServingEngine(tcfg, tp, context_len=32, device="cpu", graphs=True)


class TestProbeSteps:
    def test_probe_is_report_only_and_matches_reference(self, weights, mixed):
        """A probed step emits the tokens, exits and caches of a normal
        step (bitwise, inside the port) and reports would-exit masks for
        every branch — including branch 3, which the (2,) plan discards at
        the cloud — equal to the reference's; the flag is one-shot."""
        (jex, jc), (tex, tc) = _pair(weights, mixed, (2,))
        (_, _), (nex, nc) = _pair(weights, mixed, (2,))
        jt, tt = jnp.asarray(_toks()), torch.from_numpy(_toks())
        for i in range(3):
            jex.probe_next = tex.probe_next = i == 0
            jr, jc = jex.step(jt, i, jc)
            tr, tc = tex.step(tt, i, tc)
            nr, nc = nex.step(tt, i, nc)
            _same_step(tr, jr)
            assert sorted(tr.branch_take) == ([1, 3] if i == 0 else [1])
            assert sorted(nr.branch_take) == [1]
            for a, b in ((tr.tokens, nr.tokens), (tr.exited, nr.exited),
                         (tr.exit_tier, nr.exit_tier)):
                np.testing.assert_array_equal(a, b)
            assert tr.bytes_per_hop == nr.bytes_per_hop
            jt, tt = jr.tokens_dev[:, None], tr.tokens_dev[:, None]
        for a, b in zip(bridge.caches_to_numpy(tc)["blocks"]["self"].values(),
                        bridge.caches_to_numpy(nc)["blocks"]["self"].values()):
            np.testing.assert_array_equal(a, b)
        assert tex.trace_counts == decode_keys(jex.trace_counts)

    @pytest.mark.parametrize("compaction", ["bucketed", "off"])
    def test_sampled_probe_coverage_matches_reference(self, weights, mixed,
                                                      compaction):
        """``probe_sample_frac=0.5`` evaluates the discarded branch on half
        the batch: coverage masks and covered rows' would-exit masks equal
        the reference's (the rotation cursor included); uncovered rows
        read False, and the trajectory is untouched."""
        (jex, jc), (tex, tc) = _pair(weights, mixed, (2,), compaction=compaction)
        (_, _), (fex, fc) = _pair(weights, mixed, (2,), compaction=compaction)
        jt, tt = jnp.asarray(_toks()), torch.from_numpy(_toks())
        jex.probe_sample_frac = tex.probe_sample_frac = 0.25
        seen = np.zeros(B, bool)
        for i in range(4):
            jex.probe_next = tex.probe_next = fex.probe_next = True
            jr, jc = jex.step(jt, i, jc)
            tr, tc = tex.step(tt, i, tc)
            fr, fc = fex.step(tt, i, fc)
            _same_step(tr, jr)
            cover = tr.branch_probe_mask[3]
            assert cover.sum() == 2
            np.testing.assert_array_equal(tr.branch_take[3][cover],
                                          fr.branch_take[3][cover])
            assert not tr.branch_take[3][~cover].any()
            np.testing.assert_array_equal(tr.tokens, fr.tokens)
            seen |= cover
            jt, tt = jr.tokens_dev[:, None], tr.tokens_dev[:, None]
        if compaction == "off":
            assert seen.all()  # 4 probes x 2 rows rotate over all 8 rows
        assert tex.trace_counts == decode_keys(jex.trace_counts)

    @pytest.mark.parametrize("probe", ["alternate", "sampled"])
    def test_batched_and_per_head_probes_agree(self, weights, mixed, probe):
        """Three branches, split 2 (branch 2 at the cut and 3 in the cloud
        are probed): batched and per-head probes give bitwise the same
        tokens, masks and coverage, and both equal the reference."""
        hists = []
        for batched in (True, False):
            (jex, jc), (tex, tc) = _pair(weights, mixed, (2,), branches=(1, 2, 3),
                                         batched_heads=batched)
            if probe == "sampled":
                jex.probe_sample_frac = tex.probe_sample_frac = 0.5
            jt, tt = jnp.asarray(_toks()), torch.from_numpy(_toks())
            hist = []
            for i in range(4):
                jex.probe_next = tex.probe_next = probe == "sampled" or bool(i % 2)
                jr, jc = jex.step(jt, i, jc)
                tr, tc = tex.step(tt, i, tc)
                _same_step(tr, jr)
                hist.append(tr)
                jt, tt = jr.tokens_dev[:, None], tr.tokens_dev[:, None]
            assert sorted(hist[1].branch_take) == [1, 2, 3]
            assert tex.host_syncs == 4 + tex.overflow_retries
            hists.append(hist)
        for a, b in zip(*hists):
            _same_step(a, b, entropy=False)
            for layer in a.branch_entropy:
                np.testing.assert_allclose(a.branch_entropy[layer],
                                           b.branch_entropy[layer], rtol=0, atol=1e-6)
