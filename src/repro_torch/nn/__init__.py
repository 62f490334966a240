"""Engines: one op surface over the cleartext, joint-simulation and
party-runtime worlds (``repro/nn``)."""
