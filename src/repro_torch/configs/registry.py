"""All assigned architectures (a copy of ``repro.configs.registry``)."""
from __future__ import annotations

from .base import ArchConfig

# [audio] enc-dec, conv frontend stubbed (precomputed frame embeddings)
WHISPER_MEDIUM = ArchConfig(
    name="whisper-medium", family="encdec", enc_dec=True,
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, act="gelu", gated_mlp=False, use_bias=True,
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions, no rope
    frontend="audio-stub", enc_seq=1500, tie_embeddings=True, qk_norm=False)

GRANITE_3_2B = ArchConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab=49155, tie_embeddings=True)

COMMAND_R_35B = ArchConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22528,
    vocab=256000, use_bias=False, tie_embeddings=True)

QWEN3_0_6B = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, d_ff=3072,
    vocab=151936, qk_norm=True, rope_theta=1e6, tie_embeddings=True)

SMOLLM_135M = ArchConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, d_ff=1536,
    vocab=49152, tie_embeddings=True)

MAMBA2_780M = ArchConfig(
    name="mamba2-780m", family="ssm", ssm=True,
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_groups=1,
    conv_width=4, tie_embeddings=True)

DEEPSEEK_MOE_16B = ArchConfig(
    name="deepseek-moe-16b", family="moe", moe=True,
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1408,
    vocab=102400, n_experts=64, n_shared_experts=2, top_k=6,
    expert_d_ff=1408, first_dense_layers=1, first_dense_d_ff=10944,
    tie_embeddings=True)

GRANITE_MOE_3B = ArchConfig(
    name="granite-moe-3b-a800m", family="moe", moe=True,
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab=49155, n_experts=40, n_shared_experts=0, top_k=8, expert_d_ff=512,
    tie_embeddings=True)

RECURRENTGEMMA_2B = ArchConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, d_ff=7680,
    vocab=256000, head_dim=256, attn_kind="local", local_window=2048,
    block_pattern=("rglru", "rglru", "attn"), rnn_width=2560,
    act="gelu", tie_embeddings=True)

CHAMELEON_34B = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=65536, qk_norm=True, frontend="vq-tokens", tie_embeddings=True)

ARCHS = {c.name: c for c in (
    WHISPER_MEDIUM, GRANITE_3_2B, COMMAND_R_35B, QWEN3_0_6B, SMOLLM_135M,
    MAMBA2_780M, DEEPSEEK_MOE_16B, GRANITE_MOE_3B, RECURRENTGEMMA_2B,
    CHAMELEON_34B)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
