"""ring_matmul_roofline.train: the ring matmul's bound (``flops.
ring_matmul_bound_s`` of each call's shapes, recorded at ``ops.ring_matmul``)
over the device time of every operation launched inside those calls,
within the traced training steps, %."""


def read(run):
    return run.roofline("step")
