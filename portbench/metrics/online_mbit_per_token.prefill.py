"""online_mbit_per_token.prefill: the online wire traffic of the traced
prefills (``CostTally``) per prefilled position, Mbit."""


def read(run):
    return run.mbit_per("prefill", "positions")
