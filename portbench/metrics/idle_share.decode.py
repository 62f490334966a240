"""idle_share.decode: the share of the traced decode steps in which no
device operation ran, %."""


def read(run):
    return run.idle_share("decode")
