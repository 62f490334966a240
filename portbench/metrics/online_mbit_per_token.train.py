"""online_mbit_per_token.train: the four servers' online wire traffic
(the program's ``CostTally``, online bits) over the traced training steps,
per position processed, Mbit."""


def read(run):
    return run.mbit_per("step", "positions")
