"""Mamba2 (SSD) block (``repro/models/ssm.py``): projections, causal
depthwise conv, selective state space scan, gated RMSNorm output."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.ssd_scan.ops import ssd, ssd_decode_step
from .layers import causal_conv, rmsnorm
from .params import ParamDef
from .sharding import constrain, einsum, matmul


def _dims(cfg: ArchConfig):
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // cfg.ssm_headdim
    G, N, W = cfg.ssm_groups, cfg.ssm_state, cfg.conv_width
    conv_ch = d_inner + 2 * G * N
    return d_inner, H, G, N, W, conv_ch


def ssm_defs(cfg: ArchConfig):
    D = cfg.d_model
    d_inner, H, G, N, W, conv_ch = _dims(cfg)
    return {
        "wz": ParamDef((D, d_inner), ("embed", "inner"), fan_in=D),
        "wx": ParamDef((D, d_inner), ("embed", "inner"), fan_in=D),
        "wB": ParamDef((D, G * N), ("embed", None), fan_in=D),
        "wC": ParamDef((D, G * N), ("embed", None), fan_in=D),
        "wdt": ParamDef((D, H), ("embed", "heads"), fan_in=D),
        "dt_bias": ParamDef((H,), ("heads",), init="zeros"),
        "conv_w": ParamDef((W, conv_ch), ("conv", "inner"), fan_in=W),
        "conv_b": ParamDef((conv_ch,), ("inner",), init="zeros"),
        "A_log": ParamDef((H,), ("heads",), init="a_log"),
        "D": ParamDef((H,), ("heads",), init="ones"),
        "norm": ParamDef((d_inner,), ("inner",), init="ones"),
        "out": ParamDef((d_inner, D), ("inner", "embed"), fan_in=d_inner),
    }


def ssm_cache_defs(cfg: ArchConfig, batch: int):
    """The conv window (pre-conv inputs, compute dtype) and the f32 state."""
    d_inner, H, G, N, W, conv_ch = _dims(cfg)
    return {
        "conv": ParamDef((batch, W - 1, conv_ch), ("batch", None, "inner"),
                         init="zeros"),
        "state": ParamDef((batch, H, cfg.ssm_headdim, N),
                          ("batch", "heads", None, None), init="zeros",
                          dtype="float32"),
    }


def _causal_conv(u, w, b):
    return F.silu(causal_conv(u, w, b))


def _projections(p, x, cfg: ArchConfig):
    dt_raw = matmul(x, p["wdt"].to(x.dtype))
    z = matmul(x, p["wz"].to(x.dtype))
    u = torch.cat([matmul(x, p["wx"].to(x.dtype)),
                   matmul(x, p["wB"].to(x.dtype)),
                   matmul(x, p["wC"].to(x.dtype))], dim=-1)
    return z, u, dt_raw


def _split_conv(cu, cfg: ArchConfig, batch_shape):
    d_inner, H, G, N, _, _ = _dims(cfg)
    xc = cu[..., :d_inner]
    Bc = cu[..., d_inner:d_inner + G * N].reshape(*batch_shape, G, N)
    Cc = cu[..., d_inner + G * N:].reshape(*batch_shape, G, N)
    return xc, Bc, Cc


def ssm_block(p, x, cfg: ArchConfig, mode: str, cache=None, impl="auto"):
    """x: (B, S, D) (S == 1 for decode).  Returns (y, cache).

    Train returns no cache; prefill returns a new cache; decode updates
    ``cache`` in place and returns it, which stands in for the reference's
    donated cache buffer."""
    B, S, _ = x.shape
    d_inner, H, G, N, W, conv_ch = _dims(cfg)
    z, u, dt_raw = _projections(p, x, cfg)
    z = constrain(z, "batch", None, "inner")
    A = -torch.exp(p["A_log"].float())
    Dskip = p["D"].float()

    if mode in ("train", "prefill"):
        cu = _causal_conv(u, p["conv_w"], p["conv_b"])
        xc, Bc, Cc = _split_conv(cu, cfg, (B, S))
        dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
        y, h_final = ssd(xc.reshape(B, S, H, cfg.ssm_headdim), dt, A, Bc, Cc,
                         Dskip, chunk=cfg.ssd_chunk, impl=impl)
        y = y.reshape(B, S, d_inner)
        cache = None
        if mode == "prefill":
            # The last W - 1 pre-conv inputs.  A prompt shorter than that is
            # left-padded with zeros, the causal conv's history before the
            # first token (the reference keeps a short window there and its
            # next decode step fails).
            conv = F.pad(u, (0, 0, max(0, W - 1 - S), 0))[:, -(W - 1):]
            cache = {"conv": conv.contiguous(), "state": h_final}
    elif mode == "decode":
        u_full = torch.cat([cache["conv"].to(u.dtype), u], dim=1)  # (B, W, C)
        cu = einsum("bwc,wc->bc", u_full, p["conv_w"].to(u.dtype))
        cu = F.silu(cu + p["conv_b"].to(u.dtype))
        xc, Bc, Cc = _split_conv(cu, cfg, (B,))
        dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"].float())
        y, h_new = ssd_decode_step(cache["state"],
                                   xc.reshape(B, H, cfg.ssm_headdim), dt, A,
                                   Bc, Cc, Dskip)
        y = y.reshape(B, 1, d_inner)
        cache["state"].copy_(h_new)
        cache["conv"].copy_(u_full[:, 1:])  # u_full is a new tensor: no overlap
    else:
        raise ValueError(f"mode {mode!r}: the port runs (train, prefill, "
                         "decode)")

    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    y = constrain(y, "batch", None, "inner")
    return matmul(y, p["out"].to(x.dtype)), cache
