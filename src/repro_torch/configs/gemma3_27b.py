"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144
[hf:google/gemma-3 family].  Repeating period-6 pattern: five
sliding-window (1024) layers then one global layer; 62 = 10 x 6 scanned
blocks + a 2-layer unrolled tail (local, local), exactly as the reference
stack ends.  long_500k RUNS: local layers keep a bounded window cache; the
global layers' KV is sequence-sharded over the model axis (DESIGN.md
§Arch-applicability).
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

_LOCAL = LayerSpec(kind="attn", attention="window", window=1024)
_GLOBAL = LayerSpec(kind="attn", attention="full")

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    d_ff=21504,
    vocab_size=262144,
    head_dim=128,
    pattern=(_LOCAL,) * 5 + (_GLOBAL,),
    tail_pattern=(_LOCAL, _LOCAL),
    rope="rope",
    rope_theta=1e6,
    qk_norm=True,
    act="gelu",
    skip_shapes=(),
    long_context_ok=True,
    notes="5:1 local:global; long_500k: windowed local caches + seq-sharded global KV",
)
