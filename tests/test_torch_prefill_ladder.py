"""Padded admission's prefill body
(``models.model.prefill`` under ``models.attention.PaddedPrompt``) and its
rung ladder (``serving.tiers.admission_ladder``).

On the CPU, in fp32: the body, run eagerly on one prompt padded on the
right to a rung at or above its length, leaves its cache row as today's
unpadded row-targeted prefill does (a tight tolerance on the logits, the
K/V payloads, the conv windows and the SSM states; ``pos`` and the first
token exactly), on the dense Phi-3 smoke trunk and the Zamba2 and Mamba2
smoke trunks cut to 4 layers, at a length equal to a rung, one below a
rung, 1, shorter than the conv window, and at the ring's capacity.  Slots
past the prompt read position -1 and payload 0, a sentinel row leaves
every cache leaf bitwise as it was, and a recycled row equals a fresh one
bitwise.

On the card (``-m card``; skipped without one): graphed ``prefill_rows`` bitwise equal
to the body run eagerly there, and a ``graphs=False`` executor calling the
same body equal to the graphed one, the whole ladder captured at the first
admission, later admissions capture nothing and replay once per prompt,
``RequestScheduler._admit`` makes no synchronizing call once the ladder is
captured, and routed-expert and MLA trunks admit through the row-targeted
prefill.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import model as TM
from repro_torch.models.attention import PaddedPrompt
from repro_torch.serving import PartitionedServer, Tracer
from repro_torch.serving.tiers import ADMISSION_TOP, admission_ladder

SLOTS, CTX, ROW = 4, 64, 2
ARCHS = {"phi3_mini_3_8b": {}, "zamba2_1_2b": {"attn_every": 2}, "mamba2_130m": {}}
FP32 = dict(rtol=1e-5, atol=1e-5)
#: (prompt length, the rung the body runs at): a rung's length at that rung
#: and at the next, one below a rung, 1, shorter than the conv window's 3
#: positions, and the ring's whole capacity.
CASES = [(16, 16), (16, 32), (31, 32), (1, 16), (2, 16), (CTX, CTX)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these shapes are small, and the test run's
    workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, **kw):
    return dataclasses.replace(get_smoke_config(arch), num_layers=4, branch_layers=(1, 3),
                               dtype="float32", param_dtype="float32", **ARCHS[arch], **kw)


@pytest.fixture(scope="module", params=list(ARCHS))
def model(request):
    cfg = _cfg(request.param)
    return cfg, TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _dirty_caches(cfg, seed=5):
    """Caches whose every row holds noise (positions included), so that a
    prefill must reset what it does not write."""
    caches = TM.init_caches(cfg, SLOTS, CTX, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for _, t in _leaves(caches):
        if t.dim() == 0:
            continue
        if t.dtype == torch.int32:
            t.copy_(torch.randint(-1, CTX, t.shape, generator=g, dtype=torch.int32))
        else:
            t.copy_(torch.randn(t.shape, generator=g))
    return caches


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _prompt(cfg, params, length):
    """A prompt whose final-head logits have no near tie at the top (the
    first tokens must then agree exactly)."""
    for seed in range(100):
        toks = torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (1, length)))
        logits, _ = TM.prefill(params, toks, cfg, TM.init_caches(cfg, 1, CTX, device="cpu"))
        top = logits[0, 0].topk(2).values
        if top[0] - top[1] > 1e-3:
            return toks
    raise AssertionError("no prompt away from an argmax tie")


def _padded(params, cfg, caches, toks, bucket, row):
    padded = torch.zeros((1, bucket), dtype=torch.int64)
    padded[:, :toks.shape[1]] = toks
    plan = PaddedPrompt(torch.tensor([row]), torch.tensor([toks.shape[1]]))
    return TM.prefill(params, padded, cfg, caches, rows=plan)[0]


def _reference(params, cfg, caches, toks, row):
    """Today's unpadded row-targeted prefill into ``row``; a one-token
    prompt, which the row-targeted path does not take (S = 1 is a decode
    step there), from a solo prefill of a fresh cache copied into the row,
    which is what the row-targeted path promises to end as."""
    if toks.shape[1] > 1:
        return TM.prefill(params, toks, cfg, caches, rows=np.array([row]))[0]
    solo = TM.init_caches(cfg, 1, CTX, device="cpu")
    logits, _ = TM.prefill(params, toks, cfg, solo)
    for (path, t), (_, s) in zip(_leaves(caches), _leaves(solo)):
        if path[-1] != "length":
            t[:, row] = s[:, 0]
    return logits


@pytest.mark.parametrize("length,bucket", CASES)
def test_padded_body_matches_the_eager_row_prefill(model, length, bucket):
    cfg, params = model
    toks = _prompt(cfg, params, length)
    ref = _dirty_caches(cfg)
    got = _clone(ref)
    want_logits = _reference(params, cfg, ref, toks, ROW)
    logits = _padded(params, cfg, got, toks, bucket, ROW)
    torch.testing.assert_close(logits, want_logits, **FP32)
    assert torch.equal(logits.argmax(-1), want_logits.argmax(-1))
    for (path, a), (_, b) in zip(_leaves(got), _leaves(ref)):
        if a.dtype == torch.int32:  # pos and the step counters: exactly
            assert torch.equal(a, b), path
        else:
            torch.testing.assert_close(a, b, **FP32, msg=lambda m: f"{path}: {m}")
        other = [r for r in range(SLOTS) if r != ROW]
        if a.dim() > 1:  # every other row as it was
            assert torch.equal(a[:, other], b[:, other]), path
    for path, t in _leaves(got):
        if path[-1] == "pos":  # slots past the prompt: empty, payload 0
            ring = dict(_leaves(got))
            assert torch.equal(t[:, ROW, :length], torch.arange(length, dtype=torch.int32)
                               .expand(t.shape[0], length))
            assert bool((t[:, ROW, length:] == -1).all()), path
            for leaf in ("k", "v"):
                assert not ring[path[:-1] + (leaf,)][:, ROW, length:].any(), path


def test_sentinel_row_writes_nothing(model):
    cfg, params = model
    caches = _dirty_caches(cfg)
    before = _clone(caches)
    _padded(params, cfg, caches, _prompt(cfg, params, 20), 32, SLOTS)
    for (path, a), (_, b) in zip(_leaves(caches), _leaves(before)):
        assert torch.equal(a, b), path


def test_recycled_row_equals_a_fresh_one(model):
    cfg, params = model
    short = _prompt(cfg, params, 9)
    fresh = TM.init_caches(cfg, SLOTS, CTX, device="cpu")
    want = _padded(params, cfg, fresh, short, 16, ROW)
    used = _dirty_caches(cfg)
    _padded(params, cfg, used, _prompt(cfg, params, 40), CTX, ROW)  # a longer earlier tenant
    got = _padded(params, cfg, used, short, 16, ROW)
    assert torch.equal(got, want)
    for (path, a), (_, b) in zip(_leaves(used), _leaves(fresh)):
        if a.dim() > 1:
            assert torch.equal(a[:, ROW], b[:, ROW]), path


def test_padded_body_refuses_routed_experts():
    cfg = dataclasses.replace(get_smoke_config("qwen3_moe_30b_a3b"), num_layers=2,
                              branch_layers=(1,), dtype="float32", param_dtype="float32")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    caches = TM.init_caches(cfg, SLOTS, CTX, device="cpu")
    with pytest.raises(NotImplementedError, match="routed experts"):
        _padded(params, cfg, caches, torch.ones((1, 3), dtype=torch.int64), 16, ROW)


@pytest.mark.parametrize("cap,rungs", [
    (3072, (16, 32, 64, 128, 256, 512, 1024)),
    (4096, (16, 32, 64, 128, 256, 512, 1024)),
    (None, (16, 32, 64, 128, 256, 512, 1024)),
    (1000, (16, 32, 64, 128, 256, 512, 1000)),
    (64, (16, 32, 64)), (40, (16, 32, 40)), (8, (8,))])
def test_ladder(cap, rungs):
    assert ADMISSION_TOP == 1024
    assert admission_ladder(cap) == rungs


@pytest.mark.parametrize("arch,rungs", [
    ("phi3_mini_3_8b", (16, 32, 64)), ("zamba2_1_2b", (16, 32, 64)),
    ("mamba2_130m", admission_ladder(None))])
def test_admission_rungs_from_the_caches(arch, rungs):
    """The ladder is the caches' own: up to the rings' capacity, and for
    a trunk without a ring up to the top rung, whole from the first
    admission on."""
    cfg = _cfg(arch)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    srv = PartitionedServer(cfg, params, 2, device="cpu", slots=SLOTS, context_len=CTX)
    assert srv.executor.admission_rungs(srv.scheduler.caches) == (SLOTS, rungs)


def test_cpu_executor_admits_eagerly():
    cfg = _cfg("phi3_mini_3_8b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    srv = PartitionedServer(cfg, params, 2, device="cpu", slots=SLOTS, context_len=CTX)
    tracer = Tracer()
    srv.trace(tracer)
    srv.submit(np.arange(5, dtype=np.int32), 2)
    srv.run(max_steps=1)
    assert not srv.executor.padded_admission
    assert not any(k[0] == "prefill" for k in srv.executor.trace_counts)
    (adm,) = [s for s in tracer.spans if s.name == "admit.prefill"]
    assert (adm.attrs["mode"], adm.attrs["bucket"]) == ("eager", 5)


# ------------------------------------------------------------------ card
def _card_server(arch, graphs=None, **kw):
    cfg = _cfg(arch, ssm_chunk=64, **kw) if arch != "phi3_mini_3_8b" else _cfg(arch, **kw)
    params = TM.init_params(cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
    return PartitionedServer(cfg, params, 2, device="cuda", slots=SLOTS, context_len=CTX,
                             graphs=graphs)


def _card_rows(rng, n, vocab):
    """``n`` prompts of one length for rows 0..n-1, then sentinels."""
    plen = int(rng.integers(2, CTX))
    toks = rng.integers(0, vocab, (SLOTS, plen)).astype(np.int32)
    rows = np.array([*range(n), *([SLOTS] * (SLOTS - n))])
    return toks, rows


@pytest.mark.card
@pytest.mark.parametrize("arch", list(ARCHS))
def test_card_graphed_equals_the_padded_body(card, arch):
    srv = _card_server(arch)
    ex, sched = srv.executor, srv.scheduler
    assert ex.padded_admission and ex.graphs
    eager = _clone(sched.caches)
    rng = np.random.default_rng(0)
    for n in (1, 3, 2):
        toks, rows = _card_rows(rng, n, srv.cfg.vocab_size)
        plen = toks.shape[1]
        bucket = max(16, 1 << (plen - 1).bit_length())
        sched.caches, tok0 = ex.prefill_rows(sched.caches, toks, rows)
        assert ex.replays[("prefill", bucket)] >= n
        for i in range(n):
            padded = torch.zeros((1, bucket), dtype=torch.int64, device="cuda")
            padded[0, :plen] = torch.from_numpy(toks[i]).cuda()
            plan = PaddedPrompt(torch.tensor([rows[i]], device="cuda"),
                                torch.tensor([plen], device="cuda"))
            logits, _ = TM.prefill(ex.params, padded, srv.cfg, eager, rows=plan,
                                   use_kernels=ex.use_kernels)
            assert int(tok0[i]) == int(logits[0, 0].argmax())
        for (path, a), (_, b) in zip(_leaves(sched.caches), _leaves(eager)):
            assert torch.equal(a, b), path


@pytest.mark.card
@pytest.mark.parametrize("arch", list(ARCHS))
def test_card_eager_twin_calls_the_same_body(card, arch):
    """Without graphs the card calls the padded body directly, at the same
    rung, and leaves every cache leaf and first token as the replays do."""
    srv, twin = _card_server(arch), _card_server(arch, graphs=False)
    assert twin.executor.padded_admission and not twin.executor.graphs
    tracer = Tracer()
    twin.trace(tracer)
    rng = np.random.default_rng(3)
    for n in (2, 1, 3):
        toks, rows = _card_rows(rng, n, srv.cfg.vocab_size)
        srv.scheduler.caches, want = srv.executor.prefill_rows(srv.scheduler.caches, toks, rows)
        sp = tracer.open("admit.prefill")
        twin.scheduler.caches, got = twin.executor.prefill_rows(
            twin.scheduler.caches, toks, rows)
        tracer.close(sp)
        assert torch.equal(got, want)
        assert (sp.attrs["mode"], sp.attrs["bucket"]) == (
            "eager", max(16, 1 << (toks.shape[1] - 1).bit_length()))
    assert not any(k[0] == "prefill" for k in twin.executor.trace_counts)
    for (path, a), (_, b) in zip(_leaves(twin.scheduler.caches), _leaves(srv.scheduler.caches)):
        assert torch.equal(a, b), path


@pytest.mark.card
def test_card_admissions_after_the_first_only_replay(card):
    srv = _card_server("zamba2_1_2b")
    ex, sched = srv.executor, srv.scheduler
    rng = np.random.default_rng(1)
    toks, rows = _card_rows(rng, 1, srv.cfg.vocab_size)
    sched.caches, _ = ex.prefill_rows(sched.caches, toks, rows)
    ladder = admission_ladder(CTX)
    assert {k[1]: n for k, n in ex.trace_counts.items() if k[0] == "prefill"} == \
        {b: 1 for b in ladder}
    counts, replays = dict(ex.trace_counts), dict(ex.replays)
    for n in (2, 1, 4, 3):
        toks, rows = _card_rows(rng, n, srv.cfg.vocab_size)
        sched.caches, _ = ex.prefill_rows(sched.caches, toks, rows)
    assert ex.trace_counts == counts
    added = {k: n - replays.get(k, 0) for k, n in ex.replays.items() if k[0] == "prefill"}
    assert sum(added.values()) == 10


@pytest.mark.card
def test_card_admit_makes_no_sync(card):
    srv = _card_server("phi3_mini_3_8b")
    sched = srv.scheduler
    tracer = Tracer()
    srv.trace(tracer)
    rng = np.random.default_rng(2)
    sched.submit(rng.integers(0, 512, 7), 2)
    sched._admit()  # captures the ladder
    for plen in (3, 3, 20, 60):
        sched.submit(rng.integers(0, 512, plen), 2)
    sched.active[:] = False  # free every slot
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        admitted = sched._admit()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert len(admitted) == 4
    modes = [(s.attrs["mode"], s.attrs["bucket"]) for s in tracer.spans
             if s.name == "admit.prefill"]
    assert modes == [("capture", 16), ("replay", 16), ("replay", 32), ("replay", 64)]


@pytest.mark.card
@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "deepseek_v3_671b"])
def test_card_moe_and_mla_admit_eagerly(card, arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32", param_dtype="float32")
    params = TM.init_params(cfg, torch.Generator("cuda").manual_seed(0), device="cuda")
    split = cfg.branch_layers[0] if cfg.branch_layers else 1
    srv = PartitionedServer(cfg, params, split, device="cuda", slots=SLOTS, context_len=CTX)
    ex, sched = srv.executor, srv.scheduler
    assert ex.graphs and not ex.padded_admission
    toks = np.ones((1, 5), np.int32)
    sched.caches, _ = ex.prefill_rows(sched.caches, toks, np.array([0]))
    assert not any(k[0] == "prefill" for k in ex.trace_counts)
