"""Hand-written CUDA kernels (csrc/), plain PyTorch versions beside them."""
