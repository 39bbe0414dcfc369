"""Transformer layers (``repro/models/layers.py``): norms, RoPE and the
sinusoidal position embedding, GQA self-attention (qk-norm, bias, KV cache),
cross-attention, gated MLP, and the depthwise causal conv of the recurrent
blocks.

Layers are plain functions on tensors; ``p`` is a dict of parameter tensors.
Without a device mesh there is nothing to constrain, so ``constrain`` has no
counterpart, and ``attention_ctx_parallel`` (taken only under a mesh) waits
for the sharding work.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from .params import ParamDef


# ------------------------------------------------------------------- norms
def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def norm_defs(d_model: int) -> ParamDef:
    return ParamDef((d_model,), init="ones")


# -------------------------------------------------------------------- rope
def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                           device=x.device) / half)
    ang = positions.float()[..., None] * freqs  # (S, half)
    cos = torch.cos(ang)[..., None, :]  # (S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(positions, d_model: int):
    """(..., d_model) f32: sin then cos of positions times 10000^(-i/half)."""
    half = d_model // 2
    freqs = torch.pow(10000.0, -torch.arange(half, dtype=torch.float32,
                                             device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------- attention
def attn_defs(cfg: ArchConfig, cross: bool = False):
    D, H, KH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    d = {
        "wq": ParamDef((D, H, hd), fan_in=D),
        "wk": ParamDef((D, KH, hd), fan_in=D),
        "wv": ParamDef((D, KH, hd), fan_in=D),
        "wo": ParamDef((H, hd, D), fan_in=H * hd),
    }
    if cfg.use_bias:
        d["bq"] = ParamDef((H, hd), init="zeros")
        d["bv"] = ParamDef((KH, hd), init="zeros")
        d["bo"] = ParamDef((D,), init="zeros")
    if cfg.qk_norm and not cross:
        d["qn"] = ParamDef((hd,), init="ones")
        d["kn"] = ParamDef((hd,), init="ones")
    return d


def _proj_qkv(p, xq, xkv, cfg: ArchConfig, positions_q, positions_k,
              use_rope: bool):
    q = torch.einsum("bsd,dhk->bshk", xq, p["wq"].to(xq.dtype))
    k = torch.einsum("bsd,dhk->bshk", xkv, p["wk"].to(xkv.dtype))
    v = torch.einsum("bsd,dhk->bshk", xkv, p["wv"].to(xkv.dtype))
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
        v = v + p["bv"].to(v.dtype)
    if "qn" in p:
        q = rmsnorm(q, p["qn"], cfg.norm_eps)
        k = rmsnorm(k, p["kn"], cfg.norm_eps)
    if use_rope and cfg.rope_theta > 0:
        q = rope(q, positions_q, cfg.rope_theta)
        k = rope(k, positions_k, cfg.rope_theta)
    return q, k, v


def _out_proj(p, o, dtype):
    y = torch.einsum("bshk,hkd->bsd", o, p["wo"].to(dtype))
    if "bo" in p:
        y = y + p["bo"].to(dtype)
    return y


def attention_full_seq(p, x, cfg: ArchConfig, *, causal: bool,
                       window: Optional[int], impl: str = "auto"):
    """Train / prefill path: self-attention over the full sequence.
    Returns (y, (k, v)); train mode drops (k, v)."""
    pos = torch.arange(x.shape[1], device=x.device)
    q, k, v = _proj_qkv(p, x, x, cfg, pos, pos, use_rope=True)
    o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=causal, window=window, impl=impl)
    return _out_proj(p, o, x.dtype), (k, v)


def _cache_capacity(cfg: ArchConfig, ctx: int) -> int:
    return min(ctx, cfg.local_window) if cfg.attn_kind == "local" else ctx


def attn_cache_defs(cfg: ArchConfig, batch: int, ctx: int):
    KH, hd = cfg.n_kv_heads, cfg.hd
    cap = _cache_capacity(cfg, ctx)
    return {
        "k": ParamDef((batch, cap, KH, hd), init="zeros"),
        "v": ParamDef((batch, cap, KH, hd), init="zeros"),
        "pos": ParamDef((cap,), init="zeros", dtype="int32"),
    }


def attention_prefill_cache(k, v, cfg: ArchConfig, ctx: int):
    """Trim prefill K/V to the cache capacity (ring tail for local attn);
    empty slots carry position -1."""
    S = k.shape[1]
    cap = _cache_capacity(cfg, ctx)
    if cfg.attn_kind == "local" and S > cap:
        # ring layout: slot = pos % cap
        pos = torch.arange(S - cap, S, device=k.device)
        order = torch.argsort(pos % cap)
        return {"k": k[:, S - cap:][:, order], "v": v[:, S - cap:][:, order],
                "pos": pos[order].int()}
    pad = cap - S
    pos = torch.arange(cap, dtype=torch.int32, device=k.device)
    if pad > 0:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        pos[S:] = -1
    return {"k": k.contiguous(), "v": v.contiguous(), "pos": pos}


def attention_decode(p, x, cfg: ArchConfig, cache, pos: int, *,
                     window: Optional[int]):
    """One-token self-attention against a (ring) KV cache.

    x: (B, 1, D); pos: position of the new token; cache: {"k": (B, cap, KH,
    hd), "v": ..., "pos": (cap,)}.  The cache is updated in place and
    returned, which stands in for the reference's donated cache buffer
    (``donate_argnums=1`` of its decode step)."""
    cap = cache["k"].shape[1]
    posv = torch.full((1,), pos, device=x.device)  # no host-to-device copy
    q, k_new, v_new = _proj_qkv(p, x, x, cfg, posv, posv, use_rope=True)
    slot = pos % cap if window is not None else min(pos, cap - 1)
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["pos"][slot] = pos
    o = flash_attention(q, cache["k"], cache["v"], causal=True, window=window,
                        q_positions=posv, k_positions=cache["pos"],
                        impl="reference")
    return _out_proj(p, o, x.dtype), cache


def cross_attention(p, x, cfg: ArchConfig, enc_kv=None, enc_out=None):
    """Decoder cross-attention: K/V from the encoder's output (train and
    prefill) or from the cache (decode).  Sq differs from Sk, so it takes
    the plain attention, as in the reference; no RoPE, and of the biases
    only bq and bv.  Returns (y, (k, v))."""
    if enc_kv is None:
        k = torch.einsum("btd,dhk->bthk", enc_out, p["wk"].to(enc_out.dtype))
        v = torch.einsum("btd,dhk->bthk", enc_out, p["wv"].to(enc_out.dtype))
        if "bv" in p:
            v = v + p["bv"].to(v.dtype)
        enc_kv = (k, v)
    k, v = enc_kv
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
    o = flash_attention(q, k, v, causal=False, impl="reference")
    return _out_proj(p, o, x.dtype), enc_kv


# -------------------------------------------------------------------- conv
def causal_conv(u, w, b):
    """Depthwise causal conv over (B, S, C); w: (W, C); no activation.  The
    reference's W-step shift-and-add, not ``F.conv1d`` (cuDNN, TF32 by
    default)."""
    W, S = w.shape[0], u.shape[1]
    pad = F.pad(u, (0, 0, W - 1, 0))
    y = torch.zeros_like(u)
    for i in range(W):
        y = y + pad[:, i:i + S] * w[i].to(u.dtype)
    return y + b.to(u.dtype)


# ---------------------------------------------------------------------- MLP
def mlp_defs(cfg: ArchConfig, d_ff: Optional[int] = None):
    D = cfg.d_model
    F_ = d_ff or cfg.d_ff
    d = {
        "w_in": ParamDef((D, F_), fan_in=D),
        "w_out": ParamDef((F_, D), fan_in=F_),
    }
    if cfg.gated_mlp:
        d["w_gate"] = ParamDef((D, F_), fan_in=D)
    if cfg.use_bias:
        d["b_in"] = ParamDef((F_,), init="zeros")
        d["b_out"] = ParamDef((D,), init="zeros")
    return d


def _act(x, kind: str):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def mlp_apply(p, x, cfg: ArchConfig):
    h = x @ p["w_in"].to(x.dtype)
    if "b_in" in p:
        h = h + p["b_in"].to(x.dtype)
    if "w_gate" in p:
        h = _act(h, cfg.act) * (x @ p["w_gate"].to(x.dtype))
    else:
        h = _act(h, cfg.act)
    y = h @ p["w_out"].to(x.dtype)
    if "b_out" in p:
        y = y + p["b_out"].to(x.dtype)
    return y
