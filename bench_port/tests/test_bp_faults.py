"""The run with the timed path broken underneath comes out not correct,
for each fault a cell can have (on one card there is no exchange between
chips to leave out): an EM step that returns its state unchanged, half
of the batch left out with the mean taken over the rest, an answer
altered where it is produced, and each optimising stage returning its
start: the M-step's and the init's OU solves, the exact moves (the swap
E-step's and the polish's)."""

import numpy as np
import pytest
import torch

import control
import harness

CELLS = ["chr21-k10-fit", "chr21-k10-swap", "canon-k20-fit",
         "chr21-k10-f64"]
SEED = 2 ** 31 + 54321


def state_unchanged(monkeypatch):
    """The M-step waits for its solve and leaves the model's params and
    moments as they were."""
    from phylo_hmrf_tpu_torch.models import hmrf

    def finalize(self, handle):
        handle["fetch"].get()
        return False

    monkeypatch.setattr(hmrf.PhyloHMRF, "mstep_finalize", finalize)


def half_batch(monkeypatch):
    """The E-step's statistics pass reads every other row of each region
    and doubles the sums; its costs are means over the rows it read."""
    from phylo_hmrf_tpu_torch.models import hmrf

    finish0 = hmrf.finish_stats

    def finish(lp_k, img_f, mask_i, labels, wpp, *a, **kw):
        half = mask_i.clone()
        half[:, 1::2] = 0
        post, obs, obs2, sums = finish0(lp_k, img_f, half, labels, wpp, *a,
                                        **kw)
        return 2 * post, 2 * obs, 2 * obs2, sums

    monkeypatch.setattr(hmrf, "finish_stats", finish)


def answer_altered(monkeypatch):
    """The M-step's first mean moves by 1% of its size as it is
    produced."""
    from phylo_hmrf_tpu_torch.models import hmrf

    fin0 = hmrf.PhyloHMRF.mstep_finalize

    def finalize(self, handle):
        rolled = fin0(self, handle)
        self.means_ = np.array(self.means_)
        self.means_[0, 0] *= 1.01
        return rolled

    monkeypatch.setattr(hmrf.PhyloHMRF, "mstep_finalize", finalize)


def _no_steps(monkeypatch, name):
    """The OU solve ``name`` of the model module runs no L-BFGS step: its
    params are its start, its validity and moments worked out from
    them."""
    from phylo_hmrf_tpu_torch.models import hmrf

    solve0 = getattr(hmrf, name)

    def solve(*a, **kw):
        return solve0(*a, **dict(kw, iters=0))

    monkeypatch.setattr(hmrf, name, solve)


def mstep_solve_start(monkeypatch):
    """The M-step's solve returns its start point."""
    _no_steps(monkeypatch, "_mstep_solve_full")
    return {"mstep_fit_gap"}


def init_solve_start(monkeypatch):
    """The init's solve returns its start point."""
    _no_steps(monkeypatch, "_init_solve")
    return {"init_fit_gap"}


def moves_start(monkeypatch):
    """The exact moves return their mean field + ICM start."""
    from phylo_hmrf_tpu_torch.ops import maxflow

    monkeypatch.setattr(maxflow, "_optimize_batched", control.start_labels)
    return {"estep_change", "polish_change"}


@pytest.mark.parametrize("fault", [state_unchanged, half_batch,
                                   answer_altered, mstep_solve_start,
                                   init_solve_start, moves_start])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(tiny_cell, monkeypatch, name, fault):
    torch.manual_seed(0)
    catches = fault(monkeypatch)
    out = harness.run_cell(tiny_cell(name), SEED, 0.0, False, device="cpu",
                           log=lambda *a: None)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1
    if catches:
        # the stage's own number is the one that fails
        assert any(v is not None and v > lim
                   for k, (v, lim) in out["checks"].items() if k in catches)
