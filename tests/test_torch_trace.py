"""The serving runtime's spans (``repro_torch.serving.trace``) on the CPU:
tracing changes nothing that is served, records nothing when off, nests
its spans as the module says, and their attributes count what was
admitted and what the overflow snapshot cloned.

Fixtures: the ``phi3_mini_3_8b`` smoke config with ``num_layers=4,
branch_layers=(1, 3)`` (the scheduler tests' fixture), and the
``zamba2_1_2b`` smoke config at the same depth with a shared attention
site every 2nd layer (Mamba2 layers: the snapshot clones their whole
state), served by a ``PartitionedServer`` split after layer 2 on 4 slots,
8 requests of lengths 2-6 and budgets of 2-5 tokens, at a threshold
between the first step's branch-1 entropies so that rows exit at the
edge, and with a survivor hint over the last 2 steps, so that the cloud's
bucket moves and steps take the overflow snapshot.
"""

import dataclasses
import gc

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.multitier import bucket_for
from repro_torch.models import model as TM
from repro_torch.serving import PartitionedServer, Tracer

ARCHS = {"phi3_mini_3_8b": {}, "zamba2_1_2b": {"attn_every": 2}}
SLOTS, CONTEXT, SPLIT = 4, 32, 2

#: Where each span opens: the name of the span it nests in (None = none).
PARENT = {"sched.step": None, "sched.admit": "sched.step",
          "admit.prefill": "sched.admit", "tiers.step": "sched.step",
          "tiers.plan": "tiers.step", "tiers.snapshot": "tiers.step",
          "tiers.segment": ("tiers.step", "tiers.rerun"),
          "tiers.fetch": ("tiers.step", "tiers.rerun"), "tiers.rerun": "tiers.step",
          "tiers.report": "tiers.step", "sched.retire": "sched.step",
          "request.queued": None}


def _requests():
    rng = np.random.default_rng(3)
    return [(rng.integers(0, 256, int(rng.integers(2, 7))).astype(np.int32),
             int(rng.integers(2, 6))) for _ in range(8)]


def _serve(cfg, params, tracer=None, detach=False):
    srv = PartitionedServer(cfg, params, SPLIT, device="cpu", slots=SLOTS,
                            context_len=CONTEXT, hint_window=2)
    if tracer is not None:
        srv.trace(tracer)
        if detach:
            srv.trace(None)
    for prompt, budget in _requests():
        srv.submit(prompt, budget)
    return srv, srv.drain()


@pytest.fixture(scope="module", params=list(ARCHS))
def served(request):
    """(arch, cfg, results untraced, traced, executors, the tracer)."""
    torch.set_num_threads(1)
    arch = request.param
    base = dataclasses.replace(get_smoke_config(arch), num_layers=4,
                               branch_layers=(1, 3), **ARCHS[arch])
    params = TM.init_params(base, torch.Generator().manual_seed(0), device="cpu")
    probe = PartitionedServer(base, params, SPLIT, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (8, 1)).astype(np.int32))
    rep, _ = probe.step(tok, 0, TM.init_caches(base, 8, CONTEXT, device="cpu"))
    e = np.sort(rep.tier_result.branch_entropy[1])
    cfg = dataclasses.replace(base, exit_threshold=float((e[3] + e[4]) / 2))
    tracer = Tracer()
    off, res_off = _serve(cfg, params)
    on, res_on = _serve(cfg, params, tracer)
    return arch, cfg, res_off, res_on, off.executor, on.executor, tracer


def test_tracing_changes_nothing_served(served):
    _, _, res_off, res_on, ex_off, ex_on, tracer = served
    assert [r.rid for r in res_off] == [r.rid for r in res_on]
    for a, b in zip(res_off, res_on):
        assert (a.tokens, a.exited, a.exit_tiers) == (b.tokens, b.exited, b.exit_tiers)
    assert any(any(r.exited) for r in res_on)
    assert ex_off.host_syncs == ex_on.host_syncs
    assert ex_off.trace_counts == ex_on.trace_counts
    assert ex_off.overflow_retries == ex_on.overflow_retries


@pytest.mark.parametrize("arch", list(ARCHS))
def test_off_records_nothing(arch):
    torch.set_num_threads(1)
    cfg = dataclasses.replace(get_smoke_config(arch), num_layers=4,
                              branch_layers=(1, 3), **ARCHS[arch])
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tracer = Tracer()
    srv, results = _serve(cfg, params, tracer, detach=True)
    assert len(results) == 8
    assert srv.executor.tracer is None and srv.scheduler.tracer is None
    assert tracer.spans == [] and tracer.finish() == []


def test_spans_nest_and_carry_their_requests(served):
    _, _, _, res_on, _, _, tracer = served
    spans = tracer.spans
    by_id = {s.sid: s for s in spans}
    for s in spans:
        want = PARENT[s.name]
        got = by_id[s.parent].name if s.parent >= 0 else None
        assert got == want or (isinstance(want, tuple) and got in want), (s.name, got)
        assert s.t0 <= s.t1
        if s.parent >= 0:
            p = by_id[s.parent]
            assert p.t0 <= s.t0 and s.t1 <= p.t1
    names = {s.name for s in spans}
    assert set(PARENT) - {"tiers.rerun"} <= names
    steps = [s for s in spans if s.name == "sched.step"]
    assert [s.attrs["step"] for s in steps] == list(range(len(steps)))
    assert sum(s.attrs["admitted"] for s in steps) == len(res_on)
    # Each request: one queued span, ending where its only admission starts.
    queued = {s.rids[0]: s for s in spans if s.name == "request.queued"}
    assert sorted(queued) == sorted(r.rid for r in res_on)
    for rid, q in queued.items():
        (adm,) = [s for s in spans if s.name == "admit.prefill" and rid in s.rids]
        assert len(q.rids) == 1 and q.t0 <= q.t1 == adm.t0
    segs = [s for s in spans if s.name == "tiers.segment"]
    assert {s.attrs["mode"] for s in segs} == {"eager"}
    assert {s.attrs["index"] for s in segs} == {0, 1}
    assert all(s.device_ms is None for s in tracer.finish())  # no events on the CPU


def test_admission_counters(served):
    _, _, _, res_on, _, _, tracer = served
    admits = [s for s in tracer.spans if s.name == "admit.prefill"]
    # Prompts and prompt tokens admitted, from the admission spans.
    assert sum(len(s.rids) for s in admits) == len(res_on)
    assert sum(len(s.rids) * s.attrs["plen"] for s in admits) == sum(
        r.prompt_len for r in res_on)
    plen = {r.rid: r.prompt_len for r in res_on}
    assert all(plen[rid] == s.attrs["plen"] for s in admits for rid in s.rids)
    # Bucket rows, sentinels included.
    assert all(s.attrs["rows"] == bucket_for(len(s.rids), SLOTS) >= len(s.rids)
               for s in admits)


def test_admission_mode_and_bucket(served):
    """Each admission says how it ran and at what length: on the CPU
    eagerly, at the prompts' own length (padded admission's rung and
    ``replay`` / ``capture`` are held on the card,
    ``test_torch_prefill_ladder.py``)."""
    _, _, _, _, _, ex_on, tracer = served
    admits = [s for s in tracer.spans if s.name == "admit.prefill"]
    assert admits and not ex_on.padded_admission
    assert all(s.attrs["mode"] == "eager" and s.attrs["bucket"] == s.attrs["plen"]
               for s in admits)


def _snapshot_bytes_by_hand(caches) -> int:
    """Every step counter; each KV ring's one slot per layer and row; each
    Mamba2 layer's whole conv window and SSM state."""
    total = caches["length"].nbytes
    for name, c in caches.items():
        if name == "length":
            continue
        kv = c["self"]
        total += kv["length"].nbytes
        if "ssm" in kv:
            total += kv["conv"].nbytes + kv["ssm"].nbytes
        else:
            total += sum(kv[k][:, :, 0].nbytes for k in kv if k != "length")
    return total


def test_snapshot_bytes_by_hand(served):
    _, cfg, _, _, _, ex_on, tracer = served
    per = _snapshot_bytes_by_hand(TM.init_caches(cfg, SLOTS, CONTEXT, device="cpu"))
    snaps = [s for s in tracer.spans if s.name == "tiers.snapshot"]
    assert snaps and all(s.attrs["bytes"] == per for s in snaps)
    # A re-run restores a snapshot the same step took.
    reruns = [s for s in tracer.spans if s.name == "tiers.rerun"]
    assert len(reruns) == ex_on.overflow_retries
    snap_steps = {s.parent for s in snaps}
    assert all(s.parent in snap_steps for s in reruns)


def test_closed_spans_leave_the_collector():
    """A long window's records add nothing to the serving loop's own
    garbage collections; they come back as spans in the order they
    opened."""
    tr = Tracer()
    sp = tr.open("sched.step", step=0)
    tr.close(tr.open("admit.prefill", (1, 2), plen=3, rows=2))
    tr.record("request.queued", 1, 2, (1,))
    tr.close(sp, live=2, admitted=2)
    for _ in range(3):  # a pass untracks one level of nested tuples
        gc.collect()
    assert not any(gc.is_tracked(r) for r in tr._records)
    got = [(s.name, s.parent, s.rids, s.attrs) for s in tr.spans]
    assert got == [("sched.step", -1, (), {"step": 0, "live": 2, "admitted": 2}),
                   ("admit.prefill", 0, (1, 2), {"plen": 3, "rows": 2}),
                   ("request.queued", -1, (1,), {})]
