"""llama4-scout-17b-a16e [moe] — MoE 16 experts top-1 + shared expert.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E].  Routed top-1 over 16 experts plus a
shared expert (Llama-4's design).  "Early fusion" multimodality is outside
the assigned backbone scope.  40 heads % 16-way TP != 0: attention shards
on the flattened head*dim axis (GSPMD) in the baseline; ring (sequence
parallel) attention is the hillclimb alternative.  Full attention ->
long_500k skipped.
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    pattern=(LayerSpec(kind="attn", moe=True),),
    rope="rope",
    rope_theta=5e5,
    num_experts=16,
    top_k=1,
    shared_expert=True,
    act="swiglu",
    skip_shapes=("long_500k",),
    notes="EP=16 experts over model axis; shared expert TP-sharded",
)
