"""RG-LRU recurrent block (RecurrentGemma, ``repro/models/rglru.py``):
dual-branch with a causal conv and a gated linear recurrence:

    i_t = σ(x_t W_i),  r_t = σ(x_t W_r)
    a_t = exp(−c · softplus(Λ) · r_t),   c = 8
    h_t = a_t h_{t−1} + sqrt(1 − a_t²) · (i_t ⊙ x_t)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.rglru_scan.ops import rglru_scan
from .layers import causal_conv
from .params import ParamDef

_C = 8.0


def rglru_defs(cfg: ArchConfig):
    D = cfg.d_model
    R = cfg.rnn_width or D
    W = cfg.conv_width
    return {
        "wx": ParamDef((D, R), fan_in=D),
        "wgate": ParamDef((D, R), fan_in=D),
        "conv_w": ParamDef((W, R), fan_in=W),
        "conv_b": ParamDef((R,), init="zeros"),
        "w_i": ParamDef((R, R), fan_in=R),
        "b_i": ParamDef((R,), init="zeros"),
        "w_r": ParamDef((R, R), fan_in=R),
        "b_r": ParamDef((R,), init="zeros"),
        "lam": ParamDef((R,), init="ones"),
        "out": ParamDef((R, D), fan_in=R),
    }


def rglru_cache_defs(cfg: ArchConfig, batch: int):
    """The conv window (pre-conv inputs, compute dtype) and the f32 state."""
    R = cfg.rnn_width or cfg.d_model
    return {
        "conv": ParamDef((batch, cfg.conv_width - 1, R), init="zeros"),
        "h": ParamDef((batch, R), init="zeros", dtype="float32"),
    }


def _gates(p, xc):
    """The decay a and the gated input u of the recurrence, both f32."""
    i = torch.sigmoid(xc @ p["w_i"].to(xc.dtype) + p["b_i"].to(xc.dtype))
    r = torch.sigmoid(xc @ p["w_r"].to(xc.dtype) + p["b_r"].to(xc.dtype))
    log_a = -_C * F.softplus(p["lam"].float()) * r.float()
    a = torch.exp(log_a)
    u = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) \
        * (i.float() * xc.float())
    return a, u


def rglru_block(p, x, cfg: ArchConfig, mode: str, cache=None, impl="auto"):
    """x: (B, S, D) (S == 1 for decode).  Returns (y, cache).

    Train returns no cache; prefill returns a new cache; decode updates
    ``cache`` in place and returns it, which stands in for the reference's
    donated cache buffer."""
    B, S, _ = x.shape
    W = cfg.conv_width
    xb = x @ p["wx"].to(x.dtype)
    gate = F.gelu(x @ p["wgate"].to(x.dtype), approximate="tanh")

    if mode in ("train", "prefill"):
        xc = causal_conv(xb, p["conv_w"], p["conv_b"])  # no activation
        a, u = _gates(p, xc)
        hs, h_final = rglru_scan(a, u, h0=None, impl=impl)
        y = hs.to(x.dtype)
        cache = None
        if mode == "prefill":
            # The last W - 1 pre-conv inputs, left-padded with zeros for a
            # prompt shorter than that (the reference keeps a short window
            # there and its next decode step fails).
            conv = F.pad(xb, (0, 0, max(0, W - 1 - S), 0))[:, -(W - 1):]
            cache = {"conv": conv.contiguous(), "h": h_final}
    elif mode == "decode":
        xb_full = torch.cat([cache["conv"].to(xb.dtype), xb], dim=1)  # (B, W, R)
        xc = torch.einsum("bwc,wc->bc", xb_full, p["conv_w"].to(x.dtype))
        xc = (xc + p["conv_b"].to(x.dtype))[:, None, :]
        a, u = _gates(p, xc)
        h = a[:, 0] * cache["h"] + u[:, 0]
        y = h[:, None, :].to(x.dtype)
        cache["h"].copy_(h)
        cache["conv"].copy_(xb_full[:, 1:])  # xb_full is a new tensor: no overlap
    else:
        raise ValueError(f"mode {mode!r}: the port runs (train, prefill, "
                         "decode)")

    y = y * gate
    return y @ p["out"].to(x.dtype), cache
