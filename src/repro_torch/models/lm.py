"""Model assembly for the dense decoder LM (``repro/models/lm.py``).

Layers are grouped into *superblocks* (one period of the temporal pattern —
a single layer for uniform stacks) whose parameters are stacked along a
leading dimension; the reference's ``lax.scan`` over that dimension is a
loop here.  Decode caches are stacked along the same dimension.

Modes: "train" (full sequence, no cache; each superblock rematerialised in
the backward when ``cfg.remat``), "prefill" (full sequence, returns the
cache) and "decode" (one token against the cache, updated in place).  Dense
(attention), Mamba2 (ssm) and RG-LRU (rglru) blocks are ported for all three
modes, with the layers before and after the stack (``dec/pre{i}``,
``dec/tail{i}``).  ``model_defs`` covers every architecture, so parameter
counts hold for all of them; the blocks of the other families raise
``NotImplementedError`` until their slice of the port.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.utils.checkpoint
from torch import nn

from ..configs.base import ArchConfig
from .layers import (attn_cache_defs, attn_defs, attention_decode,
                     attention_full_seq, attention_prefill_cache, mlp_apply,
                     mlp_defs, norm_defs, rmsnorm)
from .moe import moe_defs
from .params import (ParamDef, count_params, flatten, init_tree, map_defs,
                     stack_defs, unflatten)
from .rglru import rglru_block, rglru_cache_defs, rglru_defs
from .ssm import ssm_block, ssm_cache_defs, ssm_defs

# block kinds whose forward has not been ported, and the slice that brings it
NOT_PORTED = {
    "moe": "a later slice (mixture of experts)",
    "xdense": "a later slice (encoder-decoder)",
}


# --------------------------------------------------------------- structure
def layer_kinds(cfg: ArchConfig) -> Tuple[str, ...]:
    if cfg.enc_dec:
        return ("xdense",) * cfg.n_layers
    return cfg.layer_kinds


def structure(cfg: ArchConfig):
    """(pre_kinds, superblock_kinds, n_super, tail_kinds)."""
    kinds = layer_kinds(cfg)
    if cfg.block_pattern:
        p = len(cfg.block_pattern)
        n_super = cfg.n_layers // p
        return (), tuple(cfg.block_pattern), n_super, kinds[n_super * p:]
    pre = kinds[:cfg.first_dense_layers]
    rest = kinds[cfg.first_dense_layers:]
    if any(k != rest[0] for k in rest):
        raise ValueError("non-pattern stack must be uniform")
    return pre, (rest[0],), len(rest), ()


def _check_ported(cfg: ArchConfig) -> None:
    for kind in layer_kinds(cfg):
        if kind in NOT_PORTED:
            raise NotImplementedError(
                f"{cfg.name}: {kind} blocks are not ported yet; they come "
                f"with {NOT_PORTED[kind]}")


def block_defs(cfg: ArchConfig, kind: str, d_ff_override: Optional[int] = None):
    D = cfg.d_model
    if kind == "ssm":
        return {"ln1": norm_defs(D), "ssm": ssm_defs(cfg)}
    if kind == "rglru":
        return {"ln1": norm_defs(D), "rec": rglru_defs(cfg),
                "ln2": norm_defs(D), "mlp": mlp_defs(cfg)}
    d = {"ln1": norm_defs(D), "attn": attn_defs(cfg), "ln2": norm_defs(D)}
    if kind == "moe":
        d["moe"] = moe_defs(cfg)
    else:
        d["mlp"] = mlp_defs(cfg, d_ff=d_ff_override)
    if kind == "xdense":
        d["lnx"] = norm_defs(D)
        d["xattn"] = attn_defs(cfg, cross=True)
    return d


def model_defs(cfg: ArchConfig):
    D, V = cfg.d_model, cfg.vocab
    defs = {
        "embed": ParamDef((V, D), fan_in=D),
        "final_norm": norm_defs(D),
    }
    pre, sb_kinds, n_super, tail = structure(cfg)
    dec = {}
    for i, k in enumerate(pre):
        dec[f"pre{i}"] = block_defs(cfg, "dense",
                                    d_ff_override=cfg.first_dense_d_ff or None)
    sb = {f"b{j}": block_defs(cfg, kind) for j, kind in enumerate(sb_kinds)}
    dec["stack"] = stack_defs(sb, n_super)
    for i, k in enumerate(tail):
        dec[f"tail{i}"] = block_defs(cfg, k)
    defs["dec"] = dec
    if cfg.enc_dec:
        enc_sb = {"b0": block_defs(cfg, "enc")}
        defs["enc"] = {"stack": stack_defs(enc_sb, cfg.n_enc_layers)}
        defs["enc_norm"] = norm_defs(D)
    return defs


def block_cache_defs(cfg: ArchConfig, kind: str, batch: int, ctx: int):
    if kind == "ssm":
        return ssm_cache_defs(cfg, batch)
    if kind == "rglru":
        return rglru_cache_defs(cfg, batch)
    return attn_cache_defs(cfg, batch, ctx)


def cache_defs(cfg: ArchConfig, batch: int, ctx: int):
    """Decode cache: ``dec/pre{i}``, the stacked ``dec/stack/b{j}`` and
    ``dec/tail{i}``, as in the reference."""
    _check_ported(cfg)
    pre, sb_kinds, n_super, tail = structure(cfg)
    dec = {f"pre{i}": block_cache_defs(cfg, k, batch, ctx)
           for i, k in enumerate(pre)}
    sb = {f"b{j}": block_cache_defs(cfg, kind, batch, ctx)
          for j, kind in enumerate(sb_kinds)}
    dec["stack"] = stack_defs(sb, n_super)
    for i, k in enumerate(tail):
        dec[f"tail{i}"] = block_cache_defs(cfg, k, batch, ctx)
    return {"dec": dec}


def num_params(cfg: ArchConfig) -> int:
    return count_params(model_defs(cfg))


# ------------------------------------------------------------------- model
class LM(nn.Module):
    """A model's parameters, registered under the flat keys of the
    reference's checkpoints (``embed``, ``dec/stack/b0/attn/wq``, ...);
    they require grad only for training (``trainable``)."""

    def __init__(self, cfg: ArchConfig, params, trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        for key, t in flatten(params).items():
            self.register_parameter(key, nn.Parameter(t, requires_grad=trainable))

    def tree(self):
        """The parameters as the nested dict the layer functions take."""
        return unflatten(dict(self.named_parameters()))


def init_params(cfg: ArchConfig, generator: torch.Generator,
                trainable: bool = False) -> LM:
    """Random parameters on ``generator.device``, drawn from ``generator``."""
    return LM(cfg, init_tree(model_defs(cfg), generator,
                             getattr(torch, cfg.param_dtype)), trainable)


def init_cache(cfg: ArchConfig, batch: int, ctx: int, device):
    cdt = getattr(torch, cfg.compute_dtype)
    return map_defs(
        lambda d: torch.zeros(d.shape, device=device,
                              dtype=getattr(torch, d.dtype) if d.dtype else cdt),
        cache_defs(cfg, batch, ctx))


# ------------------------------------------------------------------ blocks
def block_apply(p, x, cfg: ArchConfig, kind: str, mode: str, cache, pos,
                impl: str):
    """Returns (x, cache_out).  In prefill ``cache`` is the cache capacity
    (which a recurrent block does not need); in decode it is this layer's
    cache, updated in place; in train there is none, and cache_out is None."""
    if kind in NOT_PORTED:
        raise NotImplementedError(f"{kind} blocks come with {NOT_PORTED[kind]}")
    if kind == "ssm":
        h, cache_out = ssm_block(p["ssm"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                                 cfg, mode, cache if mode == "decode" else None,
                                 impl=impl)
        return x + h, cache_out
    if kind == "rglru":
        h, cache_out = rglru_block(p["rec"], rmsnorm(x, p["ln1"], cfg.norm_eps),
                                   cfg, mode, cache if mode == "decode" else None,
                                   impl=impl)
        x = x + h
        x = x + mlp_apply(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg)
        return x, cache_out
    window = cfg.local_window if (kind == "attn" or cfg.attn_kind == "local") \
        else None
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if mode == "decode":
        ao, cache_out = attention_decode(p["attn"], h, cfg, cache, pos,
                                         window=window)
    else:  # decoder self-attention is causal; the encoder kind waits
        ao, kv = attention_full_seq(p["attn"], h, cfg, causal=True,
                                    window=window, impl=impl)
        cache_out = attention_prefill_cache(kv[0], kv[1], cfg, cache) \
            if mode == "prefill" else None
    x = x + ao
    x = x + mlp_apply(p["mlp"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg)
    return x, cache_out


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree, as views."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, n: int):
    """The ``n`` layers of a stacked tree, each leaf split by
    ``torch.unbind``: the backward stacks the layers' gradients once, where
    indexing layer i adds a zero-padded gradient of the whole stack per
    layer (the reference's ``lax.scan`` writes each layer's slice)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ----------------------------------------------------------------- forward
def forward(params, cfg: ArchConfig, tokens, *, mode: str, cache=None,
            pos: Optional[int] = None, impl: str = "auto", cache_len=None):
    """Returns (hidden (B, S, D), cache); the cache is None in train.

    tokens: (B, S) integer (S == 1 for decode); pos: decode position;
    cache: from ``init_cache`` or a prefill, updated in place by decode."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: the port runs (train, prefill, decode)")
    _check_ported(cfg)
    cdt = getattr(torch, cfg.compute_dtype)
    pre, sb_kinds, n_super, tail = structure(cfg)
    x = params["embed"][tokens].to(cdt)
    ctx = (cache_len or tokens.shape[1]) if mode == "prefill" else None
    dec_p = params["dec"]
    dec_c = cache["dec"] if mode == "decode" else None
    new_cache, layer_caches = {}, []

    def cache_in(tree, name: str):
        """This layer's cache in decode; the cache capacity in prefill."""
        return tree[name] if mode == "decode" else ctx

    for i, kind in enumerate(pre):
        name = f"pre{i}"
        x, new_cache[name] = block_apply(dec_p[name], x, cfg, kind, mode,
                                         cache_in(dec_c, name), pos, impl)

    stack_p = _unstack(dec_p["stack"], n_super) if mode == "train" else None

    def superblock(x, i: int):
        """Superblock ``i`` of the stack in train mode."""
        p_i = stack_p[i]
        for j, kind in enumerate(sb_kinds):
            x, _ = block_apply(p_i[f"b{j}"], x, cfg, kind, mode, None, None,
                               impl)
        return x

    for i in range(n_super):
        if mode == "train":
            # the reference's jax.checkpoint(body): only x is kept between
            # superblocks, the rest is recomputed in the backward
            x = torch.utils.checkpoint.checkpoint(
                superblock, x, i, use_reentrant=False) \
                if cfg.remat else superblock(x, i)
            continue
        p_i = _layer(dec_p["stack"], i)
        c_i = _layer(dec_c["stack"], i) if mode == "decode" else None
        co = {}
        for j, kind in enumerate(sb_kinds):
            name = f"b{j}"
            x, co[name] = block_apply(p_i[name], x, cfg, kind, mode,
                                      cache_in(c_i, name), pos, impl)
        layer_caches.append(co)
    for i, kind in enumerate(tail):
        name = f"tail{i}"
        x, new_cache[name] = block_apply(dec_p[name], x, cfg, kind, mode,
                                         cache_in(dec_c, name), pos, impl)
    if mode == "prefill":  # decode updated ``cache`` in place
        new_cache["stack"] = _stack(layer_caches)
        cache = {"dec": new_cache}
    elif mode == "train":
        cache = None
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, cache


def logits_from_hidden(params, h, cfg: ArchConfig):
    """Tied-embedding LM head, in f32."""
    return torch.einsum("bsd,vd->bsv", h.float(), params["embed"].float())
