"""Model configurations the port runs (``repro/configs``)."""
