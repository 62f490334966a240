"""Launch tooling (``repro/launch``): the one-card layout, step builders,
abstract specs, the dry run and its sweep, hill-climb and report, and the
LM training launcher (``python -m repro_torch.launch.train``)."""
