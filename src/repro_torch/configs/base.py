"""Model / run configuration: a copy of ``repro.configs.base``.

The port keeps its own copy so that it imports nothing of the JAX package;
``tests/test_torch_models.py`` holds the two copies equal field by field.
One ``ModelConfig`` describes any architecture in the assigned pool, and
the port's modules run each: attention (full or sliding-window), Mamba and
RWKV-6 layers, with a SwiGLU or gelu FFN or experts, RMSNorm or LayerNorm,
RoPE, M-RoPE or no rotary embedding, and an encoder with cross-attention.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input shape (see system spec)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

ALL_SHAPES = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One position in the repeating layer pattern."""

    kind: str  # "attn" | "mamba" | "rwkv"
    attention: str = "full"  # "full" | "window"
    window: int = 0  # only for attention == "window"
    moe: bool = False  # MoE FFN at this position?


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int
    # repeating layer pattern; the stack is pattern x num_blocks (+ tail)
    pattern: Tuple[LayerSpec, ...]
    # optional unrolled tail layers when num_layers % len(pattern) != 0
    tail_pattern: Tuple[LayerSpec, ...] = ()
    # attention options
    rope: str = "rope"  # rope | mrope | none
    rope_theta: float = 1e4
    mrope_sections: Tuple[int, ...] = ()
    qk_norm: bool = False
    # MoE options
    num_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    router_aux_weight: float = 0.01
    # SSM options
    ssm_state_dim: int = 16
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    rwkv_head_size: int = 64
    # encoder-decoder
    encoder_layers: int = 0
    encoder_seq: int = 0  # stub frontend output length (e.g. audio frames)
    # misc
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "swiglu"  # swiglu | gelu
    tie_embeddings: bool = False
    vocab_pad_to: int = 16
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # which assigned shapes apply (skip rules from the system spec)
    skip_shapes: Tuple[str, ...] = ()
    # long_500k eligibility: SSM/hybrid/linear-attn or bounded-window archs
    # (full-attention layers, if any, get sequence-sharded KV -- DESIGN.md)
    long_context_ok: bool = False
    notes: str = ""

    # ---- derived -----------------------------------------------------------

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return -(-self.vocab_size // m) * m

    @property
    def num_blocks(self) -> int:
        scanned = self.num_layers - len(self.tail_pattern)
        assert scanned % len(self.pattern) == 0, (
            f"{self.name}: {scanned} scanned layers not divisible by "
            f"pattern length {len(self.pattern)}"
        )
        return scanned // len(self.pattern)

    def stages(self) -> List[Tuple[Tuple[LayerSpec, ...], int]]:
        """Layer stack as (pattern, num_blocks) stages."""
        out = [(self.pattern, self.num_blocks)]
        if self.tail_pattern:
            out.append((self.tail_pattern, 1))
        return out

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def sub_quadratic(self) -> bool:
        """True if no pattern position needs unbounded full attention --
        the gate for long_500k (system spec)."""
        return all(
            (spec.kind != "attn") or (spec.attention == "window")
            for spec in self.pattern + self.tail_pattern
        )

    def param_count(self) -> int:
        """Approximate parameter count (for 6ND roofline math)."""
        P = 0
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        for pattern, nblocks in self.stages():
            for spec in pattern:
                block = 0
                if spec.kind == "attn":
                    block += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                elif spec.kind == "mamba":
                    di = self.ssm_expand * d
                    block += d * 2 * di + di * self.ssm_conv_width + di * (
                        2 * self.ssm_state_dim + 1
                    ) + di * d + di * (di // 16 + 2 * self.ssm_state_dim)
                elif spec.kind == "rwkv":
                    block += 4 * d * d + d * (self.d_ff) * 2
                if spec.kind in ("attn", "mamba"):
                    n_ffn = 3 if self.act == "swiglu" else 2
                    if spec.moe:
                        block += self.num_experts * n_ffn * d * f + d * self.num_experts
                        if self.shared_expert:
                            block += n_ffn * d * f
                    elif spec.kind == "attn":
                        block += n_ffn * d * f
                P += block * nblocks
        P += v * d * (1 if self.tie_embeddings else 2)
        if self.is_encoder_decoder:
            n_ffn = 3 if self.act == "swiglu" else 2
            enc_block = 2 * (d * self.q_dim + d * self.kv_dim) + n_ffn * d * f
            P += self.encoder_layers * enc_block
            # decoder cross-attention
            P += self.num_layers * (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d)
        return P

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k + shared experts)."""
        if self.num_experts == 0:
            return self.param_count()
        P = self.param_count()
        d, f = self.d_model, self.d_ff
        n_ffn = 3 if self.act == "swiglu" else 2
        moe_positions = sum(
            sum(1 for s in pattern if s.moe) * nblocks
            for pattern, nblocks in self.stages()
        )
        inactive = moe_positions * (self.num_experts - self.top_k) * n_ffn * d * f
        return P - inactive


def dense_pattern(num_layers: int, moe: bool = False) -> Tuple[LayerSpec, ...]:
    return (LayerSpec(kind="attn", moe=moe),)
