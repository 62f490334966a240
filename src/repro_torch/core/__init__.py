"""Ring, PRF and protocol algebra of the port (``repro/core``)."""
