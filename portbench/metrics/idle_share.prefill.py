"""idle_share.prefill: the share of the traced prefills in which no device
operation ran, %."""


def read(run):
    return run.idle_share("prefill")
