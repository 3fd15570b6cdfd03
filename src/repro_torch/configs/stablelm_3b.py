"""stablelm-3b [dense] — MHA (kv = heads = 32).

32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304
[hf:stabilityai/stablelm-2-1_6b family].  Plain multi-head attention
(GQA degenerate case), LayerNorm, partial-rotary RoPE approximated as full
RoPE.  Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    head_dim=80,
    pattern=(LayerSpec(kind="attn"),),
    rope="rope",
    rope_theta=1e4,
    norm="layernorm",
    act="swiglu",
    skip_shapes=("long_500k",),
    notes="MHA: kv heads shard 16-way cleanly (32/16)",
)
