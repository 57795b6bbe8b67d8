"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

Wrappers run the twin for CPU tensors and launch the kernel for CUDA
tensors; ``build`` compiles ``csrc/`` at first use and counts launches.
"""
