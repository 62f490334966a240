"""device_ops_per_token.train: device operations (kernels, copies, fills)
that ran inside the traced training steps, per position processed."""


def read(run):
    return run.ops_per("step", "positions")
