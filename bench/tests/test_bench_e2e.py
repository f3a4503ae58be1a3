"""Whole runs of the harness on the CPU at a tiny size, in fp32 so that
the port and the plain reference agree to rounding: a sound run comes out
correct with readings at rounding, the control (the reference with float8
products) and the faults a served step can have come out not correct.
The same runs on the card are in ``test_bench_card.py``."""

from __future__ import annotations

import time

import pytest
import torch

from bench.calibrate import edge_entropies
from bench.gen.closed_loop import ClosedLoop
from bench.harness import runner, spec
from bench.reference.hybrid import _ssd
from bench.tests import tiny

SEED = 2 ** 31 + 11


@pytest.fixture(scope="module")
def cells():
    """The tiny dense and hybrid cells, each at the median of its own
    smallest edge-branch entropy (so about half the rows exit)."""
    torch.set_num_threads(1)
    out = {}
    for model in (tiny.DENSE, tiny.HYBRID):
        c = tiny.cell(model, 0.5)
        m = c["config_file"]["model"]
        gen = ClosedLoop(c["mix"], 0, m["vocab_size"])
        h = edge_entropies(m, 3, 0, [r.prompt for r in gen.first()], "cpu")
        out[model["arch_type"]] = tiny.cell(model, float(h.median()))
    return out


def _run(cell, traced=False, control=False):
    # A tiny cell's run: fewer warm-up and profiled steps, a smaller sample.
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(runner, "WARM_STEPS", 2)
        mp.setattr(runner, "TRACE_STEPS", 3)
        mp.setattr(runner, "MIN_TOKENS", 20)
        return runner.run_cell(cell, SEED, 0.3, traced, device="cpu",
                               t_start=time.perf_counter(), control=control)[0]


@pytest.mark.parametrize("arch", ["dense", "hybrid"])
def test_reference_agrees_with_the_port(cells, arch):
    res = _run(cells[arch], control=True)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0
    for v in res["check"].values():
        assert v["value"] <= 1e-5
    # The control fails the same comparison.
    assert not res["control_correct"], res["control"]
    names = {e["name"] for e in cells[arch]["end_to_end"]}
    assert set(res["metrics"]) == names


def test_traced_run_reports_per_layer_metrics(cells):
    res = _run(cells["dense"], traced=True)
    assert res["correct"]
    assert {"decode_step_ms", "cloud_useful_rows", "step_roofline_mfu"} <= set(res["metrics"])
    assert 0 < res["metrics"]["cloud_useful_rows"]["value"] <= 1


def _token_altered(monkeypatch):
    from repro_torch.serving.tiers import TierExecutor

    orig = TierExecutor.dispatch

    def dispatch(self, *a, **k):
        fetch, chosen, logits = orig(self, *a, **k)
        chosen = (chosen + 1) % self.cfg.vocab_size
        return dict(fetch, tokens=chosen), chosen, logits
    monkeypatch.setattr(TierExecutor, "dispatch", dispatch)


def _state_unchanged(monkeypatch):
    """Decode writes no K/V, and the SSM step hands back the state it was
    given."""
    from repro_torch.models import attention, mamba

    step = mamba.ssd_step
    monkeypatch.setattr(attention, "_cache_write", lambda cache, *a, **k: cache)
    monkeypatch.setattr(mamba, "ssd_step", lambda h, *a: (step(h, *a)[0], h))


@pytest.mark.parametrize("arch", ["dense", "hybrid"])
@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged])
def test_a_broken_step_is_not_correct(cells, arch, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(cells[arch])
    assert not res["correct"], res["check"]


def test_chunked_ssd_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    t, h, p, n = 37, 3, 4, 5
    x, b, c = (torch.randn(t, h, k, generator=g) for k in (p, n, n))
    a = -torch.rand(t, h, generator=g)
    state, ys = torch.zeros(h, p, n), []
    for i in range(t):
        state = state * a[i].exp()[:, None, None] + x[i][:, :, None] * b[i][:, None, :]
        ys.append(torch.einsum("hpn,hn->hp", state, c[i]))
    assert torch.allclose(_ssd(x, a, b, c, 8), torch.stack(ys), atol=1e-5, rtol=1e-5)


def test_weights_are_a_function_of_the_seed():
    from bench.harness import weights

    m = spec.cell("zamba2.chat")["config_file"]["model"]
    small = dict(m, num_layers=2, d_model=32, d_ff=64, vocab_size=64, num_heads=2,
                 num_kv_heads=2, head_dim=16, ssm_num_heads=4, ssm_head_dim=16,
                 ssm_state_dim=8)
    a, b = (weights.make(small, 7, "cpu") for _ in range(2))
    f = weights.make(small, 7, "cpu", dtype=torch.float32)
    assert torch.equal(a["blocks"]["mamba"]["w_xbc"], b["blocks"]["mamba"]["w_xbc"])
    assert torch.equal(a["lm_head"].float(), f["lm_head"])
    assert not torch.equal(a["embed"], weights.make(small, 8, "cpu")["embed"])
    assert (f["blocks"]["mamba"]["A_log"].exp() >= 1).all()
