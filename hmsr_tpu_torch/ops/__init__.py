"""Plain PyTorch operators and the CUDA kernel wrappers (``cuda_*``)."""
