"""The paper's ML workloads on the party runtime and over the engines
(``repro/train``)."""
