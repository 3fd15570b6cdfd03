"""whisper-medium [audio] — encoder-decoder, conv frontend stubbed.

24L d_model=1024 16H d_ff=4096 vocab=51865 [arXiv:2212.04356].
Whisper-medium is 24 encoder + 24 decoder layers; the assignment's "24L"
is read as the decoder depth with a matching 24-layer encoder.  The conv
mel frontend is a STUB: ``input_specs()`` provides precomputed frame
embeddings (1500, d_model).  Decoder layers carry self-attention (cached)
plus cross-attention into the encoder output (cached once at prefill).
Vocab 51865 padded to 51872 for 16-way TP.  Full attention -> long_500k
skipped; decode_32k runs (enc-dec has a decode step).
"""

from repro_torch.configs.base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    pattern=(LayerSpec(kind="attn"),),
    rope="none",  # whisper uses learned/sinusoidal absolute positions
    norm="layernorm",
    act="gelu",
    encoder_layers=24,
    encoder_seq=1500,
    skip_shapes=("long_500k",),
    notes="enc-dec; frontend stub provides (1500, d) frame embeddings",
)
