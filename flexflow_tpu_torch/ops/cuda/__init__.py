"""Hand-written CUDA kernels: Python wrappers, their plain PyTorch
versions and the build of csrc/."""
