"""Model FLOPs of a step: a frozen copy of the program's
``launch/roofline.py::model_flops`` and ``active_params``, on a
configuration's dict (the keys of its ``config`` group) rather than on the
program's ``ArchConfig``.

    train:   6 N_active B S + 3 L attn(B, S)
    prefill: 2 N_active B S +   L attn(B, S)

where attn is a causal self-attention layer's products (2 QK^T + 2 PV,
halved for causality) times the share of attention layers, or for an SSM
layer its chunked scan's products (2 B S (Q d_inner + 2 d_inner N))."""
from __future__ import annotations


def _head_dim(c: dict) -> int:
    return c.get("head_dim") or c["d_model"] // max(c["n_heads"], 1)


def active_params(c: dict, n_params: int) -> int:
    """Parameters a token touches (MoE: the top-k routed experts of each
    expert layer, not all of them)."""
    if not c.get("moe"):
        return n_params
    n_moe_layers = c["n_layers"] - c.get("first_dense_layers", 0)
    per_expert = 3 * c["d_model"] * c["expert_d_ff"]
    return n_params - n_moe_layers * (c["n_experts"] - c["top_k"]) * per_expert


def attention_flops_per_layer(c: dict, S: int, B: int) -> float:
    if c.get("ssm"):
        d_inner = c["ssm_expand"] * c["d_model"]
        return 2.0 * B * S * (c["ssd_chunk"] * d_inner
                              + 2 * d_inner * c["ssm_state"])
    window = c["local_window"] if c.get("attn_kind") == "local" else None
    eff_S = min(S, window) if window else S
    return 2.0 * B * S * eff_S * c["n_heads"] * _head_dim(c) * 2 * 0.5


def model_flops(c: dict, n_params: int, kind: str, B: int, S: int) -> float:
    """FLOPs of one training step or one prefill of a (B, S) batch."""
    n_act = active_params(c, n_params)
    attn = attention_flops_per_layer(c, S, B) * c["n_layers"]
    if kind == "train":
        return 6.0 * n_act * B * S + 3.0 * attn
    if kind == "prefill":
        return 2.0 * n_act * B * S + attn
    raise ValueError(f"no model FLOPs for a {kind!r} step")
