"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768 [arXiv:2401.04088].
Per the assignment line, SWA is on (window 4096), which bounds the KV cache
and makes long_500k runnable.  E=8 does not divide the 16-way model axis,
so experts are TP-sharded on d_ff instead of expert-parallel (DESIGN.md
§Arch-applicability).
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    pattern=(LayerSpec(kind="attn", attention="window", window=4096, moe=True),),
    rope="rope",
    rope_theta=1e6,
    num_experts=8,
    top_k=2,
    act="swiglu",
    skip_shapes=(),
    long_context_ok=True,
    notes="SWA window=4096 bounds KV; E=8 -> TP-sharded experts (no EP)",
)
