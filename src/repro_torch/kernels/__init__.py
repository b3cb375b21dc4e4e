"""Hand-written CUDA kernels (sources in ``repro_torch/csrc``), their
wrappers, and their plain PyTorch versions (:mod:`.ref`)."""
