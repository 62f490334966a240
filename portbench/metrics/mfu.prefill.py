"""mfu.prefill: the plain model's operations of the traced prefills
(every layer over the frontend and prompt positions, the lm_head at the
last) over the prefills' time at the card's peak in 64-bit ring
multiply-adds, %."""
from portbench import flops


def read(run):
    return run.mfu("prefill", flops.ring_peak_ops_per_s(8))
