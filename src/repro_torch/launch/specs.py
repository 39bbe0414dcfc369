"""Fake DTensor stand-ins for every (arch × shape) dry-run cell
(``repro/launch/specs.py``): the reference's shapes and shardings, no data.

Call these under a ``FakeTensorMode``: each input is a DTensor whose local
shard is a fake tensor of the rank's shape, so nothing is allocated.
Parameters and both AdamW moments are placed by ``lm.param_pspecs``, the
decode cache by ``lm.cache_pspecs``, tokens, labels and ``enc_embeds`` on
the batch axes (``("pod", "data")``) by the profile's activation rules.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..models import lm
from ..models.params import flatten, spec_tree, unflatten
from ..models.sharding import PROFILES, P, placements, spec_for


def batch_spec(mesh) -> P:
    names = [n for n in ("pod", "data") if n in mesh.shape]
    return P(tuple(names) if len(names) > 1 else (names[0] if names else None))


def _fake(mesh, shape, dtype, spec, device: str):
    """A DTensor of global ``shape`` placed by ``spec``, its shard a fake
    (or, outside a FakeTensorMode, an empty) tensor."""
    from torch.distributed.tensor import DTensor
    local = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            names = (entry,) if isinstance(entry, str) else entry
            for n in names:
                local[d] //= mesh.shape[n]
    t = torch.empty(local, dtype=dtype, device=device)
    return DTensor.from_local(t, mesh.device_mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


def _shard(mesh, defs, rules, default_dtype, device):
    specs = flatten(spec_tree(defs, mesh, rules))
    return unflatten({
        k: _fake(mesh, d.shape, getattr(torch, d.dtype) if d.dtype
                 else default_dtype, specs[k], device)
        for k, d in flatten(defs).items()})


def _batched(mesh, shape: Tuple[int, ...], dtype, profile: str, device):
    spec = spec_for(shape, ("batch",) + (None,) * (len(shape) - 1), mesh,
                    rules=PROFILES[profile][1])
    return _fake(mesh, shape, dtype, spec, device)


def _params(cfg: ArchConfig, mesh, profile: str, device):
    return _shard(mesh, lm.model_defs(cfg), PROFILES[profile][0],
                  getattr(torch, cfg.param_dtype), device)


def _inputs(cfg: ArchConfig, B: int, S: int, mesh, profile: str, device,
            labels: bool):
    batch = {"tokens": _batched(mesh, (B, S), torch.int32, profile, device)}
    if labels:
        batch["labels"] = _batched(mesh, (B, S), torch.int32, profile, device)
    if cfg.enc_dec:
        batch["enc_embeds"] = _batched(mesh, (B, cfg.enc_seq, cfg.d_model),
                                       getattr(torch, cfg.compute_dtype),
                                       profile, device)
    return batch


def train_inputs(cfg: ArchConfig, shape: ShapeSpec, mesh, profile: str = "2d",
                 device: str = "cuda"):
    """(state, batch) for ``make_train_step``."""
    params = _params(cfg, mesh, profile, device)
    moments = lambda: _params(cfg, mesh, profile, device)  # noqa: E731
    step = _fake(mesh, (), torch.int32, P(), device)
    state = {"params": params, "opt": {"m": moments(), "v": moments(),
                                       "step": step}}
    return state, _inputs(cfg, shape.batch, shape.seq, mesh, profile, device,
                          labels=True)


def prefill_inputs(cfg: ArchConfig, shape: ShapeSpec, mesh,
                   profile: str = "2d", device: str = "cuda"):
    """(params, batch) for ``make_prefill_step``."""
    return (_params(cfg, mesh, profile, device),
            _inputs(cfg, shape.batch, shape.seq, mesh, profile, device,
                    labels=False))


def decode_inputs(cfg: ArchConfig, shape: ShapeSpec, mesh, profile: str = "2d",
                  device: str = "cuda"):
    """(params, cache, tokens, pos) for ``make_decode_step``: one new token
    against a KV cache / state of shape.seq context, at its last position."""
    B, S = shape.batch, shape.seq
    cache = _shard(mesh, lm.cache_defs(cfg, B, S), PROFILES[profile][0],
                   getattr(torch, cfg.compute_dtype), device)
    return (_params(cfg, mesh, profile, device), cache,
            _batched(mesh, (B, 1), torch.int32, profile, device), S - 1)


def input_specs(cfg: ArchConfig, shape: ShapeSpec, mesh, profile: str = "2d",
                device: str = "cuda"):
    if shape.kind == "train":
        return train_inputs(cfg, shape, mesh, profile, device)
    if shape.kind == "prefill":
        return prefill_inputs(cfg, shape, mesh, profile, device)
    return decode_inputs(cfg, shape, mesh, profile, device)
