"""device_ops_per_token.decode: device operations that ran inside the
traced decode steps, per decoded token."""


def read(run):
    return run.ops_per("decode", "tokens")
