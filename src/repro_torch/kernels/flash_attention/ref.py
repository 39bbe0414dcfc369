"""Plain PyTorch versions of (GQA, causal / local) attention, mirroring
``repro/kernels/flash_attention/ref.py``.

``attention_ref``      — naive O(S²)-memory softmax attention (the oracle).
``attention_chunked``  — the same with the queries taken in blocks, so live
memory is one (block × Sk) score block; numerically equivalent.
``lse_ref``            — each row's log-sum-exp of its scaled scores, the
statistic the forward kernel saves for the backward.
``attention_bwd_ref``  — the gradient, written out from that statistic as
the backward kernels compute it (the reference has no counterpart: its
gradients come from autograd through its jnp paths).
``dkdv_partials_ref`` — the parts of dK and dV that the dK/dV kernel writes
when it splits each key tile's walk over the query tiles.
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


def _scores(q, k, causal, window):
    """Scaled f32 scores (B, KH, g, S, S) and the mask of visible keys, for
    self-attention with contiguous positions."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    qf = q.float().reshape(B, S, KH, H // KH, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float()) / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    qp, kp = pos[:, None], pos[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= qp - kp < window
    return s, mask


def lse_ref(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
            window: Optional[int] = None) -> torch.Tensor:
    """L = log sum_j exp(scale q.k_j) over the visible keys: (B, H, S) f32."""
    B, S, H, _ = q.shape
    s, mask = _scores(q, k, causal, window)
    L = torch.logsumexp(s.masked_fill(~mask, -torch.inf), dim=-1)
    return L.reshape(B, H, S)


def _bwd_terms(q, k, v, o, lse, do, causal, window):
    """P and dS (B, KH, g, S, S), dO and q as (B, S, KH, g, hd), all f32."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    g = H // KH
    s, mask = _scores(q, k, causal, window)
    L = lse.float().reshape(B, KH, g, S)[..., None]
    p = torch.where(mask, torch.exp(s - L), 0.0)  # (B, KH, g, S, S)
    dof = do.float().reshape(B, S, KH, g, hd)
    D = (do.float() * o.float()).sum(-1).reshape(B, S, KH, g)
    D = D.permute(0, 2, 3, 1)[..., None]  # (B, KH, g, S, 1)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    return p, p * (dp - D), dof, q.float().reshape(B, S, KH, g, hd)


def attention_bwd_ref(q, k, v, o, lse, do, *, causal: bool = True,
                      window: Optional[int] = None):
    """The gradient of self-attention, written out (not autograd).

    q, o, do: (B, S, H, hd); k, v: (B, S, KH, hd); lse: (B, H, S) f32 from
    the forward.  P is recomputed from q, k and L; then D = rowsum(dO o O),
    dV = P^T dO, dP = dO V^T, dS = P o (dP - D), dQ = scale dS K and
    dK = scale dS^T Q, dK and dV summed over the H/KH query heads of each KV
    group.  All in f32; returns (dq, dk, dv) in q's dtype."""
    B, S, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    p, ds, dof, qf = _bwd_terms(q, k, v, o, lse, do, causal, window)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qf) * scale
    return (dq.reshape(B, S, H, hd).to(q.dtype), dk.to(q.dtype),
            dv.to(q.dtype))


def dkdv_partials_ref(q, k, v, o, lse, do, *, splits: int, causal: bool = True,
                      window: Optional[int] = None, block: int = 64):
    """The f32 parts of dK and dV that the dK/dV kernel writes with
    ``splits`` > 1: for each ``block``-key tile it walks the (query head,
    query tile) pairs that can see a key of the tile, head by head (causal:
    the tiles from the key tile's own; a window: up to the tile's last key
    plus the window), cut into ``splits`` equal runs, [n s / splits,
    n (s + 1) / splits) of n pairs, one a part; part s sums the terms of
    its pairs.  Returns (dk_part, dv_part), (splits, B, S, KH, hd) each, dK
    already scaled; over the parts they sum to ``attention_bwd_ref``'s dk
    and dv before rounding."""
    B, S, H, hd = q.shape
    KH = k.shape[2]
    G = H // KH
    p, ds, dof, qf = _bwd_terms(q, k, v, o, lse, do, causal, window)
    # which[s, g, query, key]: 1 where the pair lies in part s's run
    which = torch.zeros((splits, G, S, S), dtype=torch.float32, device=q.device)
    for n0 in range(0, S, block):
        m_begin = n0 if causal else 0
        m_end = S if window is None else min(S, n0 + block - 1 + window)
        per_head = -(-(m_end - m_begin) // block)
        n_iter = G * per_head
        for s in range(splits):
            for it in range(n_iter * s // splits, n_iter * (s + 1) // splits):
                m0 = m_begin + it % per_head * block
                which[s, it // per_head, m0:m0 + block, n0:n0 + block] = 1.0
    dk = torch.einsum("sgqk,bhgqk,bqhgd->sbkhd", which, ds, qf) / math.sqrt(hd)
    dv = torch.einsum("sgqk,bhgqk,bqhgd->sbkhd", which, p, dof)
    return dk, dv
