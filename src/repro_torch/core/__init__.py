"""Ring, PRF, protocol algebra, and the joint simulation of the four
parties with its cost tally (``repro/core``)."""
