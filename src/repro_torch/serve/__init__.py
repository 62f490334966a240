"""Secure prediction serving on the party runtime (``repro/serve``)."""
