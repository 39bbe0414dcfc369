"""Mixture-of-experts layer parameters (``repro/models/moe.py``).

Only the parameter definitions are here, so that every architecture's
parameter count holds; the layer itself is a later slice of the port.
"""
from __future__ import annotations

from ..configs.base import ArchConfig
from .layers import mlp_defs
from .params import ParamDef


def moe_defs(cfg: ArchConfig):
    D, E, F = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    d = {
        "router": ParamDef((D, E), fan_in=D),
        "w_in": ParamDef((E, D, F), fan_in=D),
        "w_gate": ParamDef((E, D, F), fan_in=D),
        "w_out": ParamDef((E, F, D), fan_in=F),
    }
    if cfg.n_shared_experts:
        d["shared"] = mlp_defs(cfg, d_ff=cfg.n_shared_experts * cfg.expert_d_ff)
    return d
