"""Hand-written CUDA kernels of the port (sources in ``csrc/``), each with
its wrapper, launch count and plain PyTorch version."""
