"""The control at each cell's own size on the card: the program on its
own 32-bit ring (the nearest precision below the configuration's 64-bit
words) comes out not correct against the cell's limits.  Marked ``cuda``:
it needs the card and skips without one."""
import pytest

from portbench import harness, readings

SEED = 1618033988


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["phi3v-train", "phi3v-serve"])
def test_control_is_not_correct(card, workload):
    c = harness.cell(workload)
    if c["traffic"]["kind"] == "train_steps":
        nums = readings.train_reading(c, SEED, "control", card)
    else:
        nums = readings.serve_reading(c, SEED, "control", card, 10.0)
    nums = {k: nums[k] for k in c["limits"]}
    correct, compared = harness.verdict(nums, c["limits"])
    assert not correct, compared
