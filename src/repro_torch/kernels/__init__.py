"""Kernels of the port: Hopper kernels written by hand (``csrc/``), their
ctypes wrappers, and their plain PyTorch versions (``ref``)."""
