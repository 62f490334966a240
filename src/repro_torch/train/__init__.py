"""The paper's ML workloads over the engines, secure SGD on the party
runtime and the joint simulation, and the trainer with its checkpoints
(``repro/train``)."""
