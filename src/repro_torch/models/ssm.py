"""Mamba2 (SSD) block parameters (``repro/models/ssm.py``).

Only the parameter definitions are here, so that every architecture's
parameter count holds; the block itself arrives with the ``ssd_scan``
kernel in slice 2 of the port.
"""
from __future__ import annotations

from ..configs.base import ArchConfig
from .params import ParamDef


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
        "wz": ParamDef((D, d_inner), fan_in=D),
        "wx": ParamDef((D, d_inner), fan_in=D),
        "wB": ParamDef((D, G * N), fan_in=D),
        "wC": ParamDef((D, G * N), fan_in=D),
        "wdt": ParamDef((D, H), fan_in=D),
        "dt_bias": ParamDef((H,), init="zeros"),
        "conv_w": ParamDef((W, conv_ch), fan_in=W),
        "conv_b": ParamDef((conv_ch,), init="zeros"),
        "A_log": ParamDef((H,), init="a_log"),
        "D": ParamDef((H,), init="ones"),
        "norm": ParamDef((d_inner,), init="ones"),
        "out": ParamDef((d_inner, D), fan_in=d_inner),
    }
