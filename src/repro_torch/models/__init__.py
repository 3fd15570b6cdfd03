"""Model stack of the port: the dense-attention, RMSNorm, SwiGLU, RoPE path."""
