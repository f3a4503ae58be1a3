"""On the card: the cells' check at their own size, with a short window,
comes out correct for the program and not correct for the control (the
reference with float8 products).  Run on the chip:

    python3 -m pytest -q -m card bench/tests
"""

from __future__ import annotations

import time

import pytest

from bench.harness import spec
from bench.harness.runner import run_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails_on_card(card, name):
    res, _ = run_cell(spec.cell(name), 2 ** 31 + 3, 5.0, False, device="cuda",
                      t_start=time.perf_counter(), control=True)
    assert res["correct"], res["check"]
    assert not res["control_correct"], res["control"]
