"""Device coders of the port: CUDA kernels (csrc/) with plain PyTorch twins."""
