"""Everything the harness reads by name: ``BENCHMARK.json`` at the root
of the checkout, and under ``bench/`` the configuration
(``configs/<config>.json``), the cell (``workloads/<cell>.json``), the
traffic mix (``traffic/<mix>.json``), its generator (``gen/<name>.py``)
and each per-layer metric's reader (``metrics/<quantity>.py``).  A new
cell, mix or metric is new files and entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def _load(path: Path, name: str):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def generator(name: str):
    return _load(BENCH / "gen" / f"{name}.py", f"bench_gen_{name}")


def quantity(name: str) -> str:
    """What a metric measures: its name up to the first dot.  A quantity
    whose cells report different end-to-end metrics is split by a suffix
    (``decode_step_ms`` and ``decode_step_ms.reason``), each part with its
    own cells, ``moves`` and bound, one reader for all."""
    return name.split(".")[0]


def metric_reader(name: str):
    q = quantity(name)
    return _load(BENCH / "metrics" / f"{q}.py", f"bench_metric_{q}")


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell's entry in ``BENCHMARK.json`` joined with its own file,
    its configuration and its traffic mix, and the metrics it reports
    (``end_to_end`` with ``--trace 0``, ``per_layer`` with ``--trace 1``)."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    own = _json(BENCH / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if own[key] != entry[key]:
            raise ValueError(f"{name}: {key} {own[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    return dict(
        own, name=name, chips=entry["chips"],
        config_file=_json(BENCH / "configs" / f"{entry['config']}.json"),
        mix=_json(BENCH / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )
