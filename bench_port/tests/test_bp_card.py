"""On the card: one short run of the default cell from a fresh process
prints a sound result line. Skips without CUDA (decided in the test)."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
def test_short_run_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", "chr21-k10-fit",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) == {"fit_s", "em_iter_s", "setup_s"}
