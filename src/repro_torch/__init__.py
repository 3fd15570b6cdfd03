"""PyTorch and CUDA port of the ``repro`` package for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package imports nothing
from it and nothing of JAX.  Entry points run on ``cuda`` unless the
caller asks for the CPU (see :func:`repro_torch.device.resolve_device`).
"""
