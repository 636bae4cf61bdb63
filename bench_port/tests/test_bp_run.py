"""A whole run of each cell on the CPU at a small size: sound, it comes
out correct under the cell's limits; the control (the reference in the
program's place, one precision lower) comes out not correct."""

import numpy as np
import pytest

import control
import harness
from judge import Judge, verdict

CELLS = ["chr21-k10-fit", "chr21-k10-swap", "canon-k20-fit",
         "chr21-k10-f64"]
SEED = 2 ** 31 + 12345
# the swap cell at 56 x 56: on the 40 x 40 default the last E-step's
# mean field + ICM start is already a swap optimum for this seed, so its
# moves have nothing to lower (``estep_change`` reads 0, as a fault's
# does); the cell's own 653 x 653 runs read -1.9e-4 to -8.9e-3
SIZE = {"chr21-k10-swap": dict(h0=56)}


def run(cell):
    return harness.run_cell(cell, SEED, 0.0, False, device="cpu",
                            log=lambda *a: None)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_cell, name):
    out = run(tiny_cell(name, **SIZE.get(name, {})))
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"fit_s", "em_iter_s", "setup_s"}
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(harness.load_json(
        harness.HERE, "limits", name + ".json"))


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(tiny_cell, name):
    cell = tiny_cell(name, **SIZE.get(name, {}))
    data, regions, tree = harness._inputs(cell, SEED)
    rec, _ = harness.Fits(cell, data, regions, tree, "cpu").fit(SEED + 1)
    judge = Judge(data, cell.model)
    ok, checks = verdict(judge.numbers(rec), cell.limits)
    assert ok, checks
    dtype = control.lower_dtype(cell.model["dtype"])
    ok, checks = verdict(judge.numbers(
        control.control_record(judge, rec, SEED, dtype)), cell.limits)
    assert not ok, checks
    assert any(v is not None and v > lim for v, lim in checks.values())
    assert np.isfinite([v for v, _ in checks.values()]).all()
