"""Secure prediction serving on the joint simulation and the party runtime
(``repro/serve``)."""
