"""Plain PyTorch operations and the wrappers of the CUDA kernels."""
