"""rwkv6-1.6b [ssm] — "Finch": attention-free, data-dependent decay.

24L d_model=2048 d_ff=7168 vocab=65536 [arXiv:2404.05892].
WKV-6 recurrence with per-channel data-dependent decay, token-shift mixing,
and a squared-ReLU channel-mix FFN.  O(1) state per layer -> all four
shapes run, including long_500k.  Hoplite's technique applies to gradient
sync only (no attention to shard) — DESIGN.md §Arch-applicability.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,  # wkv heads = d_model / rwkv_head_size
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    head_dim=64,
    pattern=(LayerSpec(kind="rwkv"),),
    rope="none",
    rwkv_head_size=64,
    act="gelu",  # channel-mix uses squared relu internally
    norm="layernorm",
    skip_shapes=(),
    long_context_ok=True,
    notes="attention-free; decode state is O(1); ideal long-context cell",
)
