"""On the card only (each test decides inside itself, through the ``card``
fixture, whether a CUDA device is here, and skips on the CPU): a short run
of each cell end to end, and the check's control at the cell's own size,
which has to come out not correct. Run them there with

    python3 -m pytest slambench/tests/test_bench_card.py -q
"""

import json
from pathlib import Path

import pytest

from slambench import run, scene

BENCH = json.loads((Path(__file__).resolve().parent.parent.parent
                    / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell, card):
    _, w, cfg, mix, limits = run.load_cell(cell)
    out = run.run_cell(w, cfg, mix, limits, 2 ** 34 + 3, 5.0, False, card)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["metrics"]["setup_s"]["value"] > 0


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, card):
    """A window that holds as many re-inits as a run compares (a frame
    takes under 50 ms)."""
    _, w, cfg, mix, limits = run.load_cell(cell)
    seconds = 5.0 + (run.K_INITS + 1) * scene.cycle(mix) * 0.05
    out = run.run_cell(w, cfg, mix, limits, 2 ** 34 + 9, seconds, False,
                       card, control=True)
    assert out["correct"], out["checks"]
    assert not out["control_correct"], out["control_checks"]
