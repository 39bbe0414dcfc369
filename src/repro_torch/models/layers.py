"""Transformer layers (``repro/models/layers.py``): norms, RoPE and the
sinusoidal position embedding, GQA self-attention (qk-norm, bias, KV cache),
cross-attention, gated MLP, and the depthwise causal conv of the recurrent
blocks.

Layers are plain functions on tensors; ``p`` is a dict of parameter tensors.
Under a mesh (``sharding.mesh_context``) the tensors are DTensors, and
``constrain`` places the activations where the reference constrains them;
without one it returns its input.  Self-attention whose heads do not shard
over the mesh's ``model`` axis takes ``attention_ctx_parallel`` at 1024
tokens or more, as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.shards import Arg, is_dtensor, on_shards
from .params import ParamDef
from .sharding import (constrain, current_mesh, current_profile, einsum,
                       matmul)


# ------------------------------------------------------------------- norms
def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def norm_defs(d_model: int) -> ParamDef:
    return ParamDef((d_model,), (None,), init="ones")


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
        "wq": ParamDef((D, H, hd), ("embed", "heads", "head_dim"), fan_in=D),
        "wk": ParamDef((D, KH, hd), ("embed", "kv_heads", "head_dim"), fan_in=D),
        "wv": ParamDef((D, KH, hd), ("embed", "kv_heads", "head_dim"), fan_in=D),
        "wo": ParamDef((H, hd, D), ("heads", "head_dim", "embed"), fan_in=H * hd),
    }
    if cfg.use_bias:
        d["bq"] = ParamDef((H, hd), ("heads", "head_dim"), init="zeros")
        d["bv"] = ParamDef((KH, hd), ("kv_heads", "head_dim"), init="zeros")
        d["bo"] = ParamDef((D,), (None,), init="zeros")
    if cfg.qk_norm and not cross:
        d["qn"] = ParamDef((hd,), (None,), init="ones")
        d["kn"] = ParamDef((hd,), (None,), init="ones")
    return d


def _proj_qkv(p, xq, xkv, cfg: ArchConfig, positions_q, positions_k,
              use_rope: bool):
    q = einsum("bsd,dhk->bshk", xq, p["wq"].to(xq.dtype))
    k = einsum("bsd,dhk->bshk", xkv, p["wk"].to(xkv.dtype))
    v = einsum("bsd,dhk->bshk", xkv, p["wv"].to(xkv.dtype))
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
    y = einsum("bshk,hkd->bsd", o, p["wo"].to(dtype))
    if "bo" in p:
        y = y + p["bo"].to(dtype)
    return y


def _heads_shardable(cfg: ArchConfig) -> bool:
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.shape:
        return True
    if current_profile() == "fsdp":
        return True  # no TP axis in use
    return cfg.n_heads % mesh.shape["model"] == 0


def attention_ctx_parallel(q, k, v, *, causal: bool, window: Optional[int]):
    """Context-parallel attention: the query SEQUENCE dim is sharded on the
    `model` axis (K/V replicated), so score blocks shard 16-way even when the
    head count doesn't divide the mesh (e.g. smollm's 9 heads).  One big
    masked einsum — per-device score memory is S²/model_shards.  Plain
    PyTorch in f32, as the reference's jnp."""
    B, Sq, H, hd = q.shape
    q = constrain(q, "batch", "qseq", None, None)
    qf = q.float().reshape(B, Sq, k.shape[2], H // k.shape[2], hd)
    s = einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    s = s / float(hd) ** 0.5
    s = constrain(s, "batch", None, None, "qseq", None)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask[None, None, None], s, -1e30)
    p_ = torch.softmax(s, dim=-1)
    o = einsum("bhgqk,bkhd->bqhgd", p_, v.float())
    o = o.reshape(B, Sq, H, hd).to(q.dtype)
    return constrain(o, "batch", "qseq", None, None)


def attention_full_seq(p, x, cfg: ArchConfig, *, causal: bool,
                       window: Optional[int], impl: str = "auto"):
    """Train / prefill path: self-attention over the full sequence.
    Returns (y, (k, v)); train mode drops (k, v)."""
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    q, k, v = _proj_qkv(p, x, x, cfg, pos, pos, use_rope=True)
    if not _heads_shardable(cfg) and S >= 1024:
        o = attention_ctx_parallel(q, k, v, causal=causal, window=window)
    else:
        q = constrain(q, "batch", None, "heads", None)
        o = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                            causal=causal, window=window, impl=impl)
        o = constrain(o, "batch", None, "heads", None)
    return _out_proj(p, o, x.dtype), (k, v)


def _cache_capacity(cfg: ArchConfig, ctx: int) -> int:
    return min(ctx, cfg.local_window) if cfg.attn_kind == "local" else ctx


def attn_cache_defs(cfg: ArchConfig, batch: int, ctx: int):
    KH, hd = cfg.n_kv_heads, cfg.hd
    cap = _cache_capacity(cfg, ctx)
    return {
        "k": ParamDef((batch, cap, KH, hd), ("batch", None, "kv_heads", None),
                      init="zeros"),
        "v": ParamDef((batch, cap, KH, hd), ("batch", None, "kv_heads", None),
                      init="zeros"),
        "pos": ParamDef((cap,), (None,), init="zeros", dtype="int32"),
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
        k = einsum("btd,dhk->bthk", enc_out, p["wk"].to(enc_out.dtype))
        v = einsum("btd,dhk->bthk", enc_out, p["wv"].to(enc_out.dtype))
        if "bv" in p:
            v = v + p["bv"].to(v.dtype)
        enc_kv = (k, v)
    k, v = enc_kv
    q = einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    if "bq" in p:
        q = q + p["bq"].to(q.dtype)
    o = flash_attention(q, k, v, causal=False, impl="reference")
    return _out_proj(p, o, x.dtype), enc_kv


# -------------------------------------------------------------------- conv
def causal_conv(u, w, b):
    """Depthwise causal conv over (B, S, C); w: (W, C); no activation.  The
    reference's W-step shift-and-add, not ``F.conv1d`` (cuDNN, TF32 by
    default); under a mesh, on each rank's shards of the batch and the
    channels."""
    if is_dtensor(u):
        seq = {"batch": 0, "heads": 2}
        return on_shards(causal_conv, u, seq, [
            Arg(u, seq), Arg(w, {"heads": 1}), Arg(b, {"heads": 0})], [seq])
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
        "w_in": ParamDef((D, F_), ("embed", "ffn"), fan_in=D),
        "w_out": ParamDef((F_, D), ("ffn", "embed"), fan_in=F_),
    }
    if cfg.gated_mlp:
        d["w_gate"] = ParamDef((D, F_), ("embed", "ffn"), fan_in=D)
    if cfg.use_bias:
        d["b_in"] = ParamDef((F_,), ("ffn",), init="zeros")
        d["b_out"] = ParamDef((D,), (None,), init="zeros")
    return d


def _act(x, kind: str):
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def mlp_apply(p, x, cfg: ArchConfig):
    h = matmul(x, p["w_in"].to(x.dtype))
    if "b_in" in p:
        h = h + p["b_in"].to(x.dtype)
    if "w_gate" in p:
        h = _act(h, cfg.act) * matmul(x, p["w_gate"].to(x.dtype))
    else:
        h = _act(h, cfg.act)
    h = constrain(h, "batch", None, "ffn")
    y = matmul(h, p["w_out"].to(x.dtype))
    if "b_out" in p:
        y = y + p["b_out"].to(x.dtype)
    return y
