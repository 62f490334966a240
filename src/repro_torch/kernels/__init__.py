"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their plain
PyTorch versions, and the wrappers in ``ops`` that choose between them by
the device of their operands (``repro/kernels``)."""
