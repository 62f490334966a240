"""The paper's ML workloads on the party runtime (``repro/train``)."""
