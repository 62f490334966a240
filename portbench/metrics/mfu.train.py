"""mfu.train: the plain model's operations of the traced training
steps (forward and backward of every layer, the lm_head at the labelled
positions, no recompute) over the steps' time at the card's peak in 64-bit
ring multiply-adds (int8 tensor cores over 36 limb pairs), %."""
from portbench import flops


def read(run):
    return run.mfu("step", flops.ring_peak_ops_per_s(8))
