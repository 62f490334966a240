"""idle_share.train: the share of the traced training steps in which no
device operation ran (one minus the union of the device's busy intervals),
%."""


def read(run):
    return run.idle_share("step")
