"""ring_matmul_roofline.prefill: as ring_matmul_roofline.train, within the
traced prefills, %."""


def read(run):
    return run.roofline("prefill")
