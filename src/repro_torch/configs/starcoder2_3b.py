"""starcoder2-3b [dense] — GQA kv=2, RoPE.

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152 [arXiv:2402.19173].
LayerNorm + GeLU MLP (StarCoder2 uses standard-MLP, not gated).  Full
attention -> long_500k skipped.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    head_dim=128,
    pattern=(LayerSpec(kind="attn"),),
    rope="rope",
    rope_theta=1e5,
    norm="layernorm",
    act="gelu",
    skip_shapes=("long_500k",),
    notes="kv=2 heads cannot shard 16-way: GSPMD shards flattened kv dim",
)
