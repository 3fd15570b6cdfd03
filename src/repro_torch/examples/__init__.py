"""The JAX package's examples, ported: run each with ``python -m repro_torch.examples.<name>``."""
