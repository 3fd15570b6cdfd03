"""qwen3-14b [dense] — qk-norm, GQA.

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936 [hf:Qwen/Qwen3-8B
scaled per assignment].  Per-head RMS qk-norm before RoPE.  Full attention
-> long_500k skipped.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    head_dim=128,
    pattern=(LayerSpec(kind="attn"),),
    rope="rope",
    rope_theta=1e6,
    qk_norm=True,
    act="swiglu",
    skip_shapes=("long_500k",),
    notes="qk_norm per head; 40 heads % 16 != 0 -> flattened-dim TP",
)
