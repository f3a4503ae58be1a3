"""CPU tests of the benchmark harness: its files load by name, the
traffic is a function of the seed, the window's accounting, the roofline
arithmetic by hand, and that the harness loads neither JAX nor the JAX
package."""

from __future__ import annotations

import json
import math
import subprocess
import sys

import numpy as np
import pytest

from bench.harness import spec
from bench.harness.runner import end_to_end, percentile
from bench.work import counts

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    from repro_torch.configs.base import ModelConfig

    cell = spec.cell(name)
    m = cell["config_file"]["model"]
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in m.items()})
    assert cfg.num_layers == m["num_layers"]
    assert spec.generator(cell["mix"]["generator"]).ClosedLoop
    assert cell["end_to_end"] and cell["per_layer"]
    for entry in cell["per_layer"]:
        assert callable(spec.metric_reader(entry["name"]).read)
        assert entry["moves"] in {e["name"] for e in cell["end_to_end"]}
    assert set(cell["check"]["limits"]) <= {"token_gap", "exit_margin", "exit_flip_share"}
    conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert spec.ROOT / conf["file"] == spec.BENCH / "configs" / f"{conf['name']}.json"


def _loop(seed, mix="reason32"):
    mixd = json.loads((spec.BENCH / "traffic" / f"{mix}.json").read_text())
    return spec.generator("closed_loop").ClosedLoop(mixd, seed, 32064)


def test_closed_loop_is_a_function_of_the_seed():
    a, b, c = _loop(2 ** 31 + 7), _loop(2 ** 31 + 7), _loop(5)
    fa, fb, fc = a.first(), b.first(), c.first()
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new_tokens == y.max_new_tokens
               for x, y in zip(fa, fb))
    # Requests keep their ids whatever order the clients ask in.
    na = [a.next(k) for k in (3, 1, 3)]
    nb = [b.next(k) for k in (1, 3, 3)]
    assert np.array_equal(na[0].prompt, nb[1].prompt)
    assert np.array_equal(na[2].prompt, nb[2].prompt)
    # Another seed: the same sizes for the clients as a whole, other ids.
    size = sorted((len(r.prompt), r.max_new_tokens) for r in fa)
    assert size == sorted((len(r.prompt), r.max_new_tokens) for r in fc)
    assert any(not np.array_equal(x.prompt, y.prompt) for x, y in zip(fa, fc))
    assert a.context_len == 4096
    for r in fa:
        assert len(r.prompt) + r.max_new_tokens <= a.context_len and r.max_new_tokens >= 1


@pytest.mark.parametrize("mix", sorted(p.stem for p in (spec.BENCH / "traffic").glob("*.json")))
def test_lengths_follow_the_mix_law(mix):
    """Every mix cites its source, and its drawn lengths keep to the law's
    bounds, with a mean near the law's (the cut takes a little off)."""
    mixd = json.loads((spec.BENCH / "traffic" / f"{mix}.json").read_text())
    assert mixd["source"] and "arXiv:" in mixd["source"]
    gen = spec.generator(mixd["generator"]).ClosedLoop(mixd, 3, 32064)
    for drawn, law in ((gen.prompt_len, mixd["prompt_len"]), (gen.output_len, mixd["output_len"])):
        assert drawn.min() >= law["min"] and drawn.max() <= law["max"]
        assert 0.85 * law["mean"] <= drawn.mean() <= 1.05 * law["mean"]
        assert np.median(drawn) < drawn.mean()  # the tail is on the long side


def test_window_accounting_on_a_fake_clock():
    # Window [10, 20).  Request 0 started before it (warm start), 1 and 2
    # were submitted in it, 3 after its close.
    submit = {0: 5.0, 1: 11.0, 2: 19.0, 3: 20.5}
    tok = {0: [6.0, 10.0, 12.0, 14.0, 20.5], 1: [11.5, 13.5, 15.5], 2: [21.0],
           3: [21.5]}
    first = {r: ts[0] for r, ts in tok.items()}
    m, acc = end_to_end(submit, first, tok, 10.0, 20.0)
    assert acc["tokens"] == 6  # 10, 12, 14 and 11.5, 13.5, 15.5
    assert m["tokens_per_s"] == 0.6
    assert sorted(acc["submitted"]) == [1, 2]
    assert m["ttft_p95_ms"] == pytest.approx(2000.0)  # request 2: 19 -> 21
    assert m["tpot_p95_ms"] == pytest.approx(2000.0)  # both gaps 2 s
    assert acc["attempted"] == {0, 1, 2}
    # A request with no first token counts as infinite.
    del first[2]
    assert end_to_end(submit, first, tok, 10.0, 20.0)[0]["ttft_p95_ms"] == math.inf
    assert percentile(list(range(1, 101)), 95) == 95


M_DENSE = {"arch_type": "dense", "num_layers": 4, "d_model": 8, "num_heads": 2,
           "num_kv_heads": 1, "head_dim": 4, "d_ff": 16, "vocab_size": 32}
M_HYBRID = dict(M_DENSE, arch_type="hybrid", ssm_expand=2, ssm_num_heads=4,
                ssm_head_dim=4, ssm_state_dim=3, ssm_num_groups=1, attn_every=2)


@pytest.mark.parametrize("case", ["attn", "ssd", "segment", "prefill", "cache"])
def test_work_counts_by_hand(case):
    if case == "attn":
        # 2 rows, 10 valid slots in all: QK and PV, 2 FLOPs a MAC, over 2 heads of 4.
        assert counts.attn_decode(M_DENSE, 10, 2) == (4 * 2 * 4 * 10,
                                                      2 * (2 * 1 * 4 * 10 + 2 * 2 * 4 * 2))
    elif case == "ssd":
        # 4 heads x 4 x 3 fp32 state read and written; x (4 x 4) and y (4 x 4)
        # fp32, dt (4) fp32, B and C (3 each) bf16; 3 rows.
        assert counts.ssd_update(M_HYBRID, 3) == (5 * 48 * 3,
                                                  3 * (8 * 48 + 4 * 36 + 2 * 6))
    elif case == "segment":
        # Layers [0, 2) of the dense model, 3 rows, 12 valid slots, 1 head.
        w = 2 * (2 * 8 * 8 + 2 * 8 * 4 + 3 * 8 * 16)
        flops, nbytes = counts.segment(M_DENSE, 0, 2, 3, 12, 1)
        af, ab = counts.attn_decode(M_DENSE, 12, 3)
        assert flops == 2 * w * 3 + 2 * 8 * 32 * 3 + 2 * af
        assert nbytes == 2 * (w + 8 * 32 + 8 * 3) + 2 * (ab + 2 * 2 * 4 * 3)
        # The hybrid's shared block runs after layer 2 and 4 only.
        assert counts.attn_layers(M_HYBRID, 0, 4) == 2 and counts.mamba_layers(M_HYBRID, 0, 4) == 4
    elif case == "cache":
        # Split 2, 10 edge and 6 cloud K/V positions of 1 kv head of 4 in
        # bf16 (16 B a position a layer); the hybrid holds one attention
        # layer on each side and 4 x 4 x 3 fp32 of state in each of its 4
        # Mamba2 layers for each of 3 rows.
        assert counts.cache_bytes(M_DENSE, 2, 10, 6, 3) == 16 * (2 * 10 + 2 * 6)
        assert counts.cache_bytes(M_HYBRID, 2, 10, 6, 3) == 16 * (10 + 6) + 4 * 192 * 3
    else:
        w = 4 * (2 * 8 * 8 + 2 * 8 * 4 + 3 * 8 * 16)
        flops, nbytes = counts.prefill(M_DENSE, 5)
        assert flops == 2 * w * 5 + 2 * 8 * 32 + 4 * 2 * 2 * 4 * 5 * 6
        assert nbytes == 2 * (w + 8 * 32 + 8 * 5) + 4 * 2 * 2 * 4 * 5
    peaks = {"bf16_flops": 10.0, "hbm_bytes_per_s": 1.0}
    assert counts.least_seconds(30.0, 2.0, peaks) == 3.0
    assert counts.least_seconds(30.0, 5.0, peaks) == 5.0


def test_the_harness_loads_no_jax():
    code = (
        "import sys\n"
        "sys.argv = ['run.py']\n"
        "import bench.run\n"
        "from bench.harness import runner, check, spec, trace, weights\n"
        "import bench.calibrate, bench.control\n"
        "from repro_torch.serving import PartitionedServer\n"
        "from repro_torch.configs.base import ModelConfig\n"
        "from repro_torch.core.multitier import bucket_ladder\n"
        "from repro_torch.kernels import build\n"
        "b = spec.benchmark()\n"
        "for w in b['workloads']:\n"
        "    c = spec.cell(w['name']); spec.generator(c['mix']['generator'])\n"
        "for e in b['per_layer']:\n"
        "    spec.metric_reader(e['name'])\n"
        "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=spec.ROOT, env={"PYTHONPATH": f"{spec.ROOT}:{spec.ROOT / 'src'}",
                                             "PATH": "/usr/bin:/bin"}, timeout=120)
    assert out.returncode == 0, out.stderr
    top = set(out.stdout.split())
    assert "repro_torch" in top and "bench" in top
    assert not top & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_imports_nothing_of_the_program():
    for path in (spec.BENCH / "reference").glob("*.py"):
        text = path.read_text()
        assert "repro" not in text.replace("reproduc", "") and "jax" not in text, path
