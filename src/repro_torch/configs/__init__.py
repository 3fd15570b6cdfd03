"""Architecture registry of the port: the configs whose path it runs.

qwen3-14b, gemma3-27b, starcoder2-3b and stablelm-3b (dense), qwen2-vl-72b
(the VLM backbone, M-RoPE), mixtral-8x22b and llama4-scout-17b-a16e (MoE),
rwkv6-1.6b (RWKV-6, attention-free), jamba-v0.1-52b (Mamba with one
attention layer in eight, MoE on every second layer) and whisper-medium (the
encoder-decoder: a bidirectional encoder over precomputed frames, decoder
layers with cross-attention into its output).  These are every architecture
of ``repro.configs``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import LayerSpec, ModelConfig, ShapeSpec  # noqa: F401
from repro_torch.configs.gemma3_27b import CONFIG as GEMMA3
from repro_torch.configs.jamba_v0_1_52b import CONFIG as JAMBA
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as LLAMA4_SCOUT
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL
from repro_torch.configs.qwen2_vl_72b import CONFIG as QWEN2_VL
from repro_torch.configs.qwen3_14b import CONFIG as QWEN3
from repro_torch.configs.rwkv6_1_6b import CONFIG as RWKV6
from repro_torch.configs.stablelm_3b import CONFIG as STABLELM
from repro_torch.configs.starcoder2_3b import CONFIG as STARCODER2
from repro_torch.configs.whisper_medium import CONFIG as WHISPER

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in [QWEN3, GEMMA3, STARCODER2, STABLELM, QWEN2_VL, MIXTRAL, LLAMA4_SCOUT, RWKV6, JAMBA, WHISPER]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests: identical structure
    (pattern, attention flavors, MoE/SSM wiring), minimal widths."""
    head_dim = 16
    heads = 4
    ratio = max(1, cfg.num_heads // cfg.num_kv_heads)
    kv = max(1, heads // ratio)
    half = head_dim // 2
    mrope = (2, 3, 3) if cfg.rope == "mrope" else ()
    assert not mrope or sum(mrope) == half
    nblocks = min(2, cfg.num_blocks)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        num_layers=len(cfg.pattern) * nblocks + len(cfg.tail_pattern),
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        d_ff=128,
        vocab_size=509,  # deliberately non-multiple: exercises vocab padding
        head_dim=head_dim,
        mrope_sections=mrope,
        num_experts=4 if cfg.num_experts else 0,
        top_k=min(cfg.top_k, 2),
        ssm_state_dim=8,
        rwkv_head_size=16,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=32 if cfg.encoder_seq else 0,
        dtype="float32",
        param_dtype="float32",
        pattern=tuple(
            dataclasses.replace(s, window=min(s.window, 8) if s.window else 0)
            for s in cfg.pattern
        ),
        tail_pattern=tuple(
            dataclasses.replace(s, window=min(s.window, 8) if s.window else 0)
            for s in cfg.tail_pattern
        ),
    )
