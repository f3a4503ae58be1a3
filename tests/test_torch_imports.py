"""The port stands alone: importing every ``repro_torch`` module loads
neither JAX nor anything of the reference package, ``chip_smoke.py``
imports neither, and no file of the port carries the reference's TPU
rates or sizes."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_CHECK = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
for name in ("repro_torch.configs.mamba2_130m", "repro_torch.configs.zamba2_1_2b",
             "repro_torch.kernels.ssd_scan", "repro_torch.models.mamba",
             "repro_torch.core.shortest_path", "repro_torch.core.profiler",
             "repro_torch.serving.engine", "repro_torch.serving.multitier",
             "repro_torch.serving.controller", "repro_torch.examples.quickstart",
             "repro_torch.examples.partition_sweep", "repro_torch.serving.faults",
             "repro_torch.configs.qwen3_8b",
             "repro_torch.examples.serve_partitioned", "repro_torch.configs.olmo_1b",
             "repro_torch.training.tree", "repro_torch.training.optimizer",
             "repro_torch.training.train_loop", "repro_torch.training.checkpoint",
             "repro_torch.data.pipeline", "repro_torch.examples.train_branchy",
             "repro_torch.benchmarks.fig6_calibration", "repro_torch.models.moe",
             "repro_torch.configs.phi3_medium_14b", "repro_torch.configs.internvl2_76b",
             "repro_torch.configs.qwen3_moe_30b_a3b"):
    assert name in names, name
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _CHECK], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 61


def test_chip_smoke_imports_no_jax_and_no_reference():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    top = {m.split(".")[0] for m in mods}
    assert "repro_torch" in top
    assert not top & {"jax", "jaxlib", "repro"}, top


def test_flash_decode_ab_imports_no_jax_and_no_reference():
    """The A/B timing script runs on the card beside chip_smoke.py."""
    tree = ast.parse((ROOT / "experiments" / "flash_decode_ab.py").read_text())
    top = {a.name.split(".")[0] for node in ast.walk(tree) if isinstance(node, ast.Import)
           for a in node.names}
    top |= {(node.module or "").split(".")[0] for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom)}
    assert {"repro_torch", "chip_smoke"} <= top
    assert not top & {"jax", "jaxlib", "repro"}, top


def test_port_holds_no_tpu_rates():
    """TPU v5e's bf16 peak (197e12) and HBM rate (819e9), and the TPU
    fleet's DCN (12.5e9) and ICI (50e9) rates, appear nowhere in the port
    (450e9, NVLink's rate, does not match)."""
    pat = re.compile(r"(?<![\d.])(197e12|819e9|12\.5e9|50e9)(?!\d)")
    hits = [f"{p.relative_to(ROOT)}: {m.group(0)}"
            for p in sorted((ROOT / "src" / "repro_torch").rglob("*"))
            if p.is_file() and p.suffix in (".py", ".cu", ".h", ".cuh")
            for m in pat.finditer(p.read_text())]
    assert not hits, hits
    assert pat.search("x = 50e9") and not pat.search("link_bw=450e9")
