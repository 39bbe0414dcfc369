"""Architecture + input-shape configuration system (a copy of
``repro.configs.base``; the port imports nothing of ``repro``).

Every assigned architecture is an ``ArchConfig``; the four assigned input
shapes are ``ShapeSpec``s.  ``reduced()`` derives the structure-preserving
small config used by CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    qk_norm: bool = False
    use_bias: bool = False
    act: str = "silu"
    gated_mlp: bool = True
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    # attention pattern
    attn_kind: str = "full"  # full | local
    local_window: int = 2048
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500  # post-conv-frontend frames (frontend stubbed)
    frontend: Optional[str] = None  # audio-stub | vq-tokens | None
    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    first_dense_layers: int = 0
    first_dense_d_ff: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm: bool = False
    ssm_state: int = 128
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    ssd_chunk: int = 256
    # hybrid temporal pattern, e.g. ("rglru", "rglru", "attn")
    block_pattern: Optional[Tuple[str, ...]] = None
    rnn_width: Optional[int] = None
    # numerics / training
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    ce_chunk: int = 512  # sequence-chunked cross entropy

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kinds over the decoder stack."""
        if self.ssm:
            return ("ssm",) * self.n_layers
        if self.block_pattern:
            p = self.block_pattern
            return tuple(p[i % len(p)] for i in range(self.n_layers))
        kinds = []
        for i in range(self.n_layers):
            if self.moe and i >= self.first_dense_layers:
                kinds.append("moe")
            else:
                kinds.append("dense")
        return tuple(kinds)

    def reduced(self) -> "ArchConfig":
        """Structure-preserving small config for CPU smoke tests."""
        if self.block_pattern:
            # one full pattern period + the stack's remainder layers
            pat = len(self.block_pattern)
            n_layers = pat + self.n_layers % pat
        elif self.moe:
            n_layers = self.first_dense_layers + 2
        else:
            n_layers = 2
        heads = min(self.n_heads, 4)
        kv = max(1, min(self.n_kv_heads, heads))
        while heads % kv:
            kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=n_layers,
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=64,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=16,
            d_ff=128,
            vocab=256,
            enc_seq=min(self.enc_seq, 16),
            n_experts=min(self.n_experts, 8) if self.moe else 0,
            top_k=min(self.top_k, 2) if self.moe else 0,
            expert_d_ff=32 if self.moe else 0,
            # drop-free capacity so decode-vs-full consistency is exact
            capacity_factor=float(min(self.n_experts, 8)) if self.moe else 1.25,
            first_dense_d_ff=64 if self.first_dense_d_ff else 0,
            ssm_state=16 if self.ssm else self.ssm_state,
            ssm_headdim=16 if self.ssm else self.ssm_headdim,
            ssd_chunk=8,
            local_window=min(self.local_window, 8),
            rnn_width=64 if self.rnn_width else None,
            ce_chunk=8,
            compute_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    """long_500k needs sub-quadratic attention: SSM / hybrid only (see
    DESIGN.md §Shape-cell skips)."""
    if shape.name == "long_500k":
        return cfg.family in ("ssm", "hybrid")
    return True
