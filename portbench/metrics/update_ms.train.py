"""update_ms.train: the optimizer's update of a training step (its
``update``, called by ``train_step``), host time between synchronisations
of the card, mean over the traced steps, ms."""


def read(run):
    return run.mean_ms("update_s")
