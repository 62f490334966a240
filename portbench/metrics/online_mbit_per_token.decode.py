"""online_mbit_per_token.decode: the online wire traffic of the traced
decode steps (``CostTally``) per decoded token, Mbit."""


def read(run):
    return run.mbit_per("decode", "tokens")
