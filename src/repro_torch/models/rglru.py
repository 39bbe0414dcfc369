"""RG-LRU recurrent block parameters (``repro/models/rglru.py``).

Only the parameter definitions are here, so that every architecture's
parameter count holds; the block itself arrives with the ``rglru_scan``
kernel in slice 3 of the port.
"""
from __future__ import annotations

from ..configs.base import ArchConfig
from .params import ParamDef


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
