"""Parameter/cache definition trees (``repro/models/params.py``).

Components describe their parameters once as nested dicts of ``ParamDef``
(shape + logical sharding axes + init); the same tree materialises as torch
tensors, counts its parameters, or gives each leaf's partition spec on a
mesh (``spec_tree``), so shapes, inits and shardings cannot drift apart.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from .sharding import PARAM_RULES, spec_for


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple
    init: str = "normal"  # normal | zeros | ones | a_log
    fan_in: Optional[int] = None  # for normal init scale 1/sqrt(fan_in)
    dtype: Optional[str] = None  # override tree dtype (e.g. f32 states)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def map_defs(fn, tree):
    if is_def(tree):
        return fn(tree)
    return {k: map_defs(fn, v) for k, v in tree.items()}


def stack_defs(tree, n: int):
    """Prepend a stacked-layers dim (unsharded) to every def."""
    def f(d: ParamDef) -> ParamDef:
        return dataclasses.replace(d, shape=(n,) + tuple(d.shape),
                                   axes=(None,) + tuple(d.axes))
    return map_defs(f, tree)


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """Nested dict -> flat ``a/b/c`` keys (``repro/train/checkpoint.py``)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def unflatten(flat: Dict[str, object]):
    root: Dict[str, object] = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def init_tree(tree, generator: torch.Generator, dtype: torch.dtype):
    """Materialise ``tree`` on ``generator.device``; normal inits draw from
    ``generator`` in flat-key order."""
    device = generator.device

    def make(d: ParamDef):
        dt = getattr(torch, d.dtype) if d.dtype else dtype
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        if d.init == "a_log":  # mamba A_log init: log(uniform[1,16])
            h = d.shape[-1] if d.shape else 1
            a = torch.linspace(1.0, 16.0, h, dtype=torch.float32, device=device)
            return torch.log(a).expand(d.shape).to(dt).clone()
        fan = d.fan_in or (d.shape[0] if d.shape else 1)
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x / math.sqrt(fan)).to(dt)

    return unflatten({k: make(d) for k, d in flatten(tree).items()})


def spec_tree(tree, mesh, rules=PARAM_RULES):
    return map_defs(lambda d: spec_for(d.shape, d.axes, mesh, rules), tree)


def count_params(tree) -> int:
    return sum(math.prod(d.shape) for d in flatten(tree).values())
