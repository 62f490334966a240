"""Engines: one op surface over the cleartext and joint-simulation worlds
(``repro/nn``)."""
