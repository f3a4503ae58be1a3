"""The port's dry run (``repro_torch.launch.dryrun``) on fake process
groups, on the CPU: nothing is computed and nothing allocated (every
leaf a DTensor over a ``meta`` local shard).

* All ten smoke configs at ``decode_32k`` on a fake (2, 4) mesh, and a
  dense, an MoE and an audio one (OLMo-1B, Qwen3-30B-A3B, Whisper) at
  ``train_4k`` and ``prefill_32k``: status ``ok``, the record's keys, this
  rank's param bytes equal to the policy's arithmetic (each leaf's bytes
  over the axes that shard it), argument bytes that hold the params, the
  step's FLOPs and collectives counted, and no process group left behind.
* Qwen3-8B at full size at ``decode_32k`` on the production (16, 16) mesh
  of a fake 256-rank group, through ``main`` (the command line): one
  ``ok`` record written, the summary line printed.
* Whisper at ``long_500k``: ``skipped`` with the reference's reason.
"""

import json
import math

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import COLLECTIVES
from repro_torch.sharding.policy import ShardingPolicy, param_shapes, tree_paths

MESH = (2, 4)
KEYS = {"arch", "shape", "mesh", "kind", "moe_dispatch", "tag", "status", "trace_s",
        "memory", "dot_flops", "hbm_bytes", "hbm_argument_bytes",
        "collectives", "num_params", "active_params", "sliding_window"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the test run's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """Duck-typed mesh: the policy reads only ``.shape`` (a dict)."""

    def __init__(self, axes: dict):
        self.shape = dict(axes)


def policy_param_bytes(cfg, axes: dict) -> int:
    """This rank's param bytes by the policy's arithmetic: each leaf's
    bytes over the sizes of the mesh axes its spec names."""
    pol = ShardingPolicy(FakeMesh(axes), cfg, tuple(a for a in ("pod", "data") if a in axes))
    total = 0
    for path, t in tree_paths(param_shapes(cfg)):
        n = t.numel()
        for e in pol.param_spec(path, tuple(t.shape)):
            for a in ((e,) if isinstance(e, str) else e or ()):
                n //= axes[a]
        total += n * t.element_size()
    return total


def check_record(rec, cfg, axes):
    assert rec["status"] == "ok", rec.get("trace")
    assert KEYS <= set(rec), KEYS - set(rec)
    mem = rec["memory"]
    assert mem["param_bytes"] == policy_param_bytes(cfg, axes)
    assert mem["argument_bytes"] > mem["param_bytes"] > 0
    assert mem["peak_bytes_est"] >= mem["argument_bytes"]
    assert rec["dot_flops"] > 0 and rec["hbm_bytes"] > 0
    assert set(rec["collectives"]) == set(COLLECTIVES) | {"_counts"}
    assert sum(rec["collectives"]["_counts"].values()) > 0
    assert rec["num_params"] == cfg.num_params()
    assert rec["active_params"] == cfg.active_params()
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_decode_on_a_fake_mesh(arch):
    cfg = get_smoke_config(arch)
    rec = dryrun.run_one(arch, "decode_32k", False, out_dir=None, cfg=cfg, mesh_shape=MESH)
    assert rec["mesh"] == "2x4" and rec["kind"] == "decode"
    check_record(rec, cfg, dict(data=2, model=4))


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k"])
@pytest.mark.parametrize("arch", ["olmo_1b", "qwen3_moe_30b_a3b", "whisper_medium"])
def test_smoke_train_and_prefill_on_a_fake_mesh(arch, shape):
    cfg = get_smoke_config(arch)
    rec = dryrun.run_one(arch, shape, False, out_dir=None, cfg=cfg, mesh_shape=MESH)
    check_record(rec, cfg, dict(data=2, model=4))
    if shape == "train_4k":
        # the train state: params, AdamW's two fp32 moments, the batch
        assert rec["memory"]["argument_bytes"] > 2 * rec["memory"]["param_bytes"]
        assert rec["memory"]["output_bytes"] >= rec["memory"]["param_bytes"]


def test_full_size_decode_through_the_command_line(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    dryrun.main(["--arch", "qwen3_8b", "--shape", "decode_32k"])
    out = capsys.readouterr().out
    assert "ok=1 skipped=0 errors=0" in out
    path = tmp_path / "qwen3_8b__decode_32k__pod16x16.json"
    rec = json.loads(path.read_text())
    cfg = get_config("qwen3_8b")
    check_record(rec, cfg, dict(data=16, model=16))
    assert rec["mesh"] == "pod16x16" and rec["sliding_window"] == 0
    # a second call reads the record back instead of tracing again
    assert dryrun.run_one("qwen3_8b", "decode_32k", False, out_dir=tmp_path) == rec


def test_whisper_long_context_is_skipped():
    rec = dryrun.run_one("whisper_medium", "long_500k", False, out_dir=None)
    assert rec["status"] == "skipped" and "1500" in rec["reason"]
    assert not dist.is_initialized()


def test_long_context_runs_the_sliding_window_variant():
    cfg = get_smoke_config("qwen3_8b")
    rec = dryrun.run_one("qwen3_8b", "long_500k", False, out_dir=None, cfg=cfg,
                         mesh_shape=MESH)
    check_record(rec, cfg, dict(data=2, model=4))
    assert rec["sliding_window"] == 8192
    # the ring holds the window, not 524,288 slots
    b = INPUT_SHAPES["long_500k"].global_batch
    ring = 2 * cfg.num_layers * b * 8192 * cfg.num_kv_heads * cfg.head_dim * 2
    assert rec["memory"]["argument_bytes"] < ring / math.prod(MESH) * 4 + 1e7


@pytest.mark.parametrize("arch", ["qwen3_8b", "qwen3_moe_30b_a3b"])
def test_smoke_decode_on_a_pod_mesh(arch):
    """The multi-pod layout's three axes ("pod", "data", "model"), at
    (2, 2, 2): the batch over pod and data."""
    cfg = get_smoke_config(arch)
    rec = dryrun.run_one(arch, "decode_32k", True, out_dir=None, cfg=cfg,
                         mesh_shape=(2, 2, 2))
    assert rec["mesh"] == "2x2x2"
    check_record(rec, cfg, dict(pod=2, data=2, model=2))
