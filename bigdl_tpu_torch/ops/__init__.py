"""Kernel wrappers of the port: each op holds its plain PyTorch version
and the wrapper of its hand-written CUDA kernel (``csrc/``).  A CUDA
tensor launches the kernel or raises; a CPU tensor runs the plain
version."""
