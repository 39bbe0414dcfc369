"""AdamW with global-norm clipping and a cosine schedule
(``repro/train/optimizer.py``), with the reference's arithmetic: the same
f32 operations in the same order, bias correction, and decoupled weight
decay on every parameter with two or more dimensions (so the stacked
per-layer norm scales, (n_layers, D), are decayed as in the reference).

The reference returns new arrays; the port writes the new parameters and
moments into the old tensors in place, so a step holds no second copy of
them, and returns the same dicts.  XLA fuses the reference's update into
one pass; PyTorch makes each operation's f32 temporary whole, about eight
of them alive at once, which for one of granite-moe-3b-a800m's 4 GB expert
stacks is 30 GB beside its 52.8 GB of state.  So a large leaf is updated in
slices along its first dimension, ``SLICE_ELEMENTS`` at most at a time;
each element's arithmetic is the same, so the result is too, bit for bit.

Under a mesh the parameters, gradients and moments are DTensors, each
leaf's placed alike: the global norm is a DTensor reduction, and the update,
elementwise, runs on each rank's shards.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..kernels.shards import is_dtensor
from ..models.params import flatten, unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


SLICE_ELEMENTS = 1 << 24  # 64 MB of f32 a temporary


def _slices(t: torch.Tensor):
    """Index ranges along dim 0 of at most SLICE_ELEMENTS elements (one
    row if a row is larger); the whole tensor if it is a scalar."""
    if t.ndim == 0 or t.numel() <= SLICE_ELEMENTS:
        return [slice(None)]
    rows = max(1, SLICE_ELEMENTS // (t.numel() // t.shape[0]))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def lr_at(step, oc: OptConfig) -> torch.Tensor:
    """Linear warm-up, then a cosine down to ``min_lr_frac``; f32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(oc.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - oc.warmup_steps)
                    / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = oc.min_lr_frac + (1 - oc.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return oc.lr * warm * cos


def init_opt_state(params):
    """Zero moments shaped as ``params`` and step 0 (int32), on its device."""
    flat = flatten(params)
    zeros = lambda: unflatten({k: torch.zeros_like(p) for k, p in flat.items()})
    device = next(iter(flat.values())).device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _local(t):
    """A DTensor's shard on this rank (replicated for a scalar), else the
    tensor itself."""
    return t.to_local() if is_dtensor(t) else t


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in flatten(tree).values()))


@torch.no_grad()
def adamw_update(params, grads, opt_state, oc: OptConfig):
    """One AdamW step; returns (params, opt_state, grad_norm), the params
    and moments updated in place."""
    step = opt_state["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(oc.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    lr = lr_at(step, oc)
    c1 = 1.0 - oc.b1 ** step.float()
    c2 = 1.0 - oc.b2 ** step.float()
    scale, lr, c1, c2 = (_local(t) for t in (scale, lr, c1, c2))
    flat_g = flatten(grads)
    flat_m, flat_v = flatten(opt_state["m"]), flatten(opt_state["v"])
    for key, whole in flatten(params).items():
        leaf, grad, mom, vel = (_local(t) for t in (
            whole, flat_g[key], flat_m[key], flat_v[key]))
        for sl in _slices(leaf):
            p = leaf[sl]
            g = grad[sl].float() * scale
            m = oc.b1 * mom[sl].float() + (1 - oc.b1) * g
            v = oc.b2 * vel[sl].float() + (1 - oc.b2) * g * g
            mhat = m / c1
            vhat = v / c2
            delta = mhat / (torch.sqrt(vhat) + oc.eps)
            if leaf.ndim >= 2:  # decoupled weight decay on matrices only
                delta = delta + oc.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
            mom[sl].copy_(m)
            vel[sl].copy_(v)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}, gn
