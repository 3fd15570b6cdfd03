"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536 [arXiv:2403.19887].
Jamba period-8 block: one attention layer (position 4 in the reference
implementation; position 0 here — the interleave ratio is what matters for
compute/communication), seven Mamba layers; MoE FFN on every second layer.
Sub-quadratic overall (only 4 attention layers), so long_500k runs with a
sequence-sharded KV cache for the attention positions.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    pattern=tuple(
        LayerSpec(kind=("attn" if p == 0 else "mamba"), moe=(p % 2 == 1))
        for p in range(8)
    ),
    rope="none",  # Jamba uses no positional encoding (Mamba carries position)
    num_experts=16,
    top_k=2,
    ssm_state_dim=16,
    ssm_expand=2,
    ssm_conv_width=4,
    act="swiglu",
    skip_shapes=(),
    long_context_ok=True,
    notes="hybrid SSM+attn; attention KV cache exists only at 1/8 of layers",
)
