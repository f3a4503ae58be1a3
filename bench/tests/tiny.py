"""A tiny cell for CPU runs of the whole harness: both configurations'
kinds of trunk at smoke widths, in fp32, so that the program and the
reference agree to rounding."""

from __future__ import annotations

import copy

from bench.harness import spec

DENSE = {
    "name": "tiny-dense", "arch_type": "dense", "source": "test", "num_layers": 4,
    "d_model": 64, "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
    "vocab_size": 96, "mlp_type": "swiglu", "rope_theta": 10000.0,
    "norm_type": "rmsnorm", "branch_layers": [1, 2, 3], "exit_threshold": 0.5,
    "dtype": "float32", "param_dtype": "bfloat16", "tie_embeddings": False,
}
HYBRID = dict(DENSE, name="tiny-hybrid", arch_type="hybrid", num_layers=4,
              ssm_state_dim=8, ssm_num_heads=4, ssm_head_dim=32, ssm_expand=2,
              ssm_chunk=8, ssm_conv_width=4, ssm_num_groups=1, attn_every=2,
              branch_layers=[1, 3])
MIX = {"generator": "closed_loop", "clients": 4,
       "prompt_len": {"mean": 10, "sigma": 0.5, "min": 5, "max": 20},
       "output_len": {"mean": 6, "sigma": 0.5, "min": 3, "max": 9}}
LIMITS = {"token_gap": 1e-3, "exit_margin": 1e-4}


def cell(model: dict, threshold: float, split: int = 3) -> dict:
    """A cell dict as :func:`bench.harness.spec.cell` returns one."""
    bench = spec.benchmark()
    m = dict(copy.deepcopy(model), exit_threshold=threshold)
    return {
        "name": f"{m['name']}.test", "chips": 1,
        "check": {"limits": dict(LIMITS)},
        "config_file": {"model": m, "serving": {"split": split}},
        "mix": dict(MIX),
        "end_to_end": [e for e in bench["end_to_end"]],
        "per_layer": [e for e in bench["per_layer"]],
    }
