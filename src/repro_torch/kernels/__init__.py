"""Kernels of the port: hand-written CUDA for Hopper, their plain versions, and ``ops``."""
