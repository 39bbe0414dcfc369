"""Gradient compression with error feedback (``repro/train/compression.py``).

Per-tensor symmetric int8 quantize-dequantize of each gradient, with an
error-feedback accumulator (Karimireddy et al., 2019) that re-injects the
quantization error at the next step.  Without a mesh the collective that
would carry the int8 values is absent; the numerics are the reference's.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch

from ..models.params import flatten, unflatten


def quantize_dequantize_int8(g: torch.Tensor):
    """Symmetric per-tensor int8 quantize->dequantize; returns (ĝ, error)."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    deq = q * scale
    return deq, gf - deq


def compress_grads(grads, error_state):
    """Error feedback + int8 q/dq on every gradient leaf.

    error_state: a tree like ``grads`` of f32 running errors, or None on the
    first step.  Returns (compressed grads in their dtype, new error state)."""
    flat = flatten(grads)
    errs = flatten(error_state) if error_state is not None else {
        k: torch.zeros_like(g, dtype=torch.float32) for k, g in flat.items()}
    comp, new_err = {}, {}
    for key, g in flat.items():
        deq, new_err[key] = quantize_dequantize_int8(g.float() + errs[key])
        comp[key] = deq.to(g.dtype)
    return unflatten(comp), unflatten(new_err)
