"""The benchmark's own tests: bench_port/ on the import path, and a tiny
cell built from a real one for the CPU."""

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)
# the tests' fits are small; several workers share the cores
torch.set_num_threads(2)


@pytest.fixture
def tiny_cell():
    """``make(workload, h0=40, K=4, max_iter=4)``: the workload's cell with
    its limits, on regions of h0 x h0 (+7 bins a further region), K states
    and a few EM iterations, for a run on the CPU."""
    import harness

    def make(name, h0=40, K=4, max_iter=4):
        spec = harness.load_json(ROOT, "BENCHMARK.json")
        cell = harness.cell_from_spec(spec, ROOT, name)
        cell.config["regions"] = [
            dict(r, h0=h0 + 7 * i, w0=h0 + 7 * i)
            for i, r in enumerate(cell.config["regions"])]
        cell.config["model"].update(n_states=K, max_iter=max_iter)
        return cell

    return make
