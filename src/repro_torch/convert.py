"""Carry a ``repro`` parameter tree across to the port.

The caller hands over the reference's parameters as nested dicts of numpy
arrays (``jax.device_get(params)``); the port imports nothing of JAX.  Every
key and shape is checked against the port's own ``model_defs`` both ways.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import resolve_device
from .configs.base import ArchConfig
from .models.lm import LM, model_defs
from .models.params import flatten


def state_dict_from_tree(tree, cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """Nested dicts of arrays -> {flat key: tensor}, checked against ``cfg``."""
    flat = flatten(tree)
    want = {k: tuple(d.shape) for k, d in flatten(model_defs(cfg)).items()}
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise KeyError(f"{cfg.name}: parameter keys differ: missing {missing}, "
                       f"unexpected {extra}")
    out = {}
    for key, shape in want.items():
        a = np.asarray(flat[key])
        if a.shape != shape:
            raise ValueError(f"{cfg.name}: {key} has shape {a.shape}, "
                             f"expected {shape}")
        out[key] = torch.from_numpy(np.array(a))  # a writable copy
    return out


def module_from_tree(tree, cfg: ArchConfig, device="cuda") -> LM:
    """The port's model holding the reference's parameters on ``device``
    (the card unless the caller asks for the CPU; without a card it raises)."""
    device = resolve_device(device)
    sd = state_dict_from_tree(tree, cfg)
    return LM(cfg, {k: t.to(device) for k, t in sd.items()})
