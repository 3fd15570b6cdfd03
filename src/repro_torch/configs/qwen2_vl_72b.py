"""qwen2-vl-72b [vlm] — M-RoPE, dynamic-resolution ViT frontend (stub).

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064 [arXiv:2409.12191].
The vision frontend is a STUB per the system spec: ``input_specs()``
provides precomputed patch embeddings merged into the token stream; the
backbone applies multimodal rotary position embedding over (temporal, h, w)
sections of the head dim.  Pure full attention -> long_500k is skipped.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    head_dim=128,
    pattern=(LayerSpec(kind="attn"),),
    rope="mrope",
    mrope_sections=(16, 24, 24),  # temporal / height / width (sums to hd/2)
    act="swiglu",
    skip_shapes=("long_500k",),
    notes="VLM backbone only; patch embeddings arrive pre-computed (stub)",
)
