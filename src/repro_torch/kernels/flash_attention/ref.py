"""Plain PyTorch versions of (GQA, causal / local) attention, mirroring
``repro/kernels/flash_attention/ref.py``.

``attention_ref``      — naive O(S²)-memory softmax attention (the oracle).
``attention_chunked``  — the same with the queries taken in blocks, so live
memory is one (block × Sk) score block; numerically equivalent.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_positions: Optional[torch.Tensor] = None,
                  k_positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Sk, KH, hd) with H % KH == 0.

    Masking uses absolute positions (default arange); a key slot whose
    position is negative is invalid.  Scores and softmax in f32."""
    B, Sq, H, hd = q.shape
    _, Sk, KH, _ = k.shape
    g = H // KH
    if q_positions is None:
        q_positions = torch.arange(Sq, device=q.device)
    if k_positions is None:
        k_positions = torch.arange(Sk, device=q.device)
    qf = q.float().reshape(B, Sq, KH, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    s = s / math.sqrt(hd)  # the scalar is taken in f32, as the reference's
    qp, kp = q_positions[:, None], k_positions[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    mask &= kp >= 0  # slots marked invalid with pos=-1
    s = s.masked_fill(~mask, -torch.inf)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(torch.isfinite(s), p, 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      block_q: int = 512) -> torch.Tensor:
    """Query-blocked attention; same contract as ``attention_ref`` with
    contiguous positions.  Falls back to ``attention_ref`` when Sq is not a
    multiple of the block, as the reference does."""
    B, Sq, H, hd = q.shape
    _, Sk, KH, _ = k.shape
    g = H // KH
    bq = min(block_q, Sq)
    if Sq % bq:
        return attention_ref(q, k, v, causal=causal, window=window)
    scale = 1.0 / float(hd) ** 0.5
    kf, vf = k.float(), v.float()
    kpos = torch.arange(Sk, device=q.device)[None, :]
    out = []
    for q0 in range(0, Sq, bq):
        q_f = q[:, q0:q0 + bq].float().reshape(B, bq, KH, g, hd) * scale
        s = torch.einsum("bqhgd,bkhd->bhgqk", q_f, kf)
        qpos = torch.arange(q0, q0 + bq, device=q.device)[:, None]
        mask = torch.ones((bq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window is not None:
            mask &= qpos - kpos < window
        # finite sentinel (not -inf): fully masked rows stay NaN-free
        s = s.masked_fill(~mask, -1e30)
        p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
        p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        out.append(torch.einsum("bhgqk,bkhd->bqhgd", p, vf))
    return torch.cat(out, dim=1).reshape(B, Sq, H, hd).to(q.dtype)
