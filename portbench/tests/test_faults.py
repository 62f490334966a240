"""The rest of a run, past the look for a card, with the timed path broken
underneath: each fault a cell can have turns ``correct`` false.  (The
exchange between chips cannot be left out: every cell runs on one card.)

On the CPU at SMOKE widths, and marked ``cuda`` at the cells' own sizes on
the card, where the unbroken run is correct too.  At SMOKE widths the
truncations' noise is a larger share of the training step's gradients
than at the cell's widths, so an unbroken training run there lies above
the cell's limits, which were set from the card's readings; an unbroken
serving run does not."""
import time

import pytest

from portbench import faults, harness
from portbench.tests.small import small_cell

SEED = 2718281828
FAULTS = [("phi3v-train", "unchanged"), ("phi3v-train", "half_batch"),
          ("phi3v-serve", "token"), ("phi3v-serve", "stale_cache")]


def _run(c, device, fault=None, seconds=0.3):
    remove = faults.plant(fault) if fault else None
    try:
        result, compared = harness.run_cell(c, SEED, seconds, False, device,
                                            time.perf_counter())
    finally:
        if remove:
            remove()
    return result, compared


def test_unbroken_serving_run_is_correct():
    result, compared = _run(small_cell("phi3v-serve"), "cpu")
    assert result["correct"], compared
    assert list(result)[:3] == ["correct", "attempted", "failed"]


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_fault_is_not_correct(workload, fault):
    result, compared = _run(small_cell(workload), "cpu", fault)
    assert not result["correct"], compared


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault",
                         [("phi3v-train", None), ("phi3v-serve", None)]
                         + FAULTS)
def test_cell_on_the_card(card, workload, fault):
    result, compared = _run(harness.cell(workload), card, fault, 4.0)
    assert result["correct"] is (fault is None), compared
