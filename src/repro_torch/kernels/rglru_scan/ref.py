"""RG-LRU (RecurrentGemma) linear recurrence, plain PyTorch versions
(``repro/kernels/rglru_scan/ref.py``).

Given per-step decay a_t ∈ (0, 1) and pre-gated input u_t (the caller forms
u_t = sqrt(1 − a_t²) · i_t ⊙ x_t):

    h_t = a_t · h_{t-1} + u_t

``rglru_scan_ref`` is the sequential f32 loop, the oracle the CUDA kernel is
held against; ``rglru_scan_assoc`` is a log-depth scan, the plain path of the
model (the JAX package's path off the TPU).  ``rglru_scan_bwd_ref`` is the
reverse loop of the gradient, the oracle of the CUDA backward kernel.
"""
from __future__ import annotations

import torch


def rglru_scan_ref(a, u, h0=None):
    """a, u: (B, S, R); h0: (B, R) or None (zeros).

    Returns (h_seq (B, S, R) in u's dtype, h_final (B, R) f32).  Each step
    is one f32 product and one f32 sum, each rounded, in that order."""
    af, uf = a.float(), u.float()
    h = torch.zeros_like(uf[:, 0]) if h0 is None else h0.float()
    hs = torch.empty_like(uf)
    for t in range(a.shape[1]):
        h = af[:, t] * h + uf[:, t]
        hs[:, t] = h
    return hs.to(u.dtype), h


def rglru_scan_assoc(a, u, h0=None):
    """The same recurrence in log2(S) doubling steps: step d composes each
    position with the one d before it, (a, u)[t - d] then (a, u)[t] giving
    (a[t - d]·a[t], a[t]·u[t - d] + u[t]).  Returns what ``rglru_scan_ref``
    returns, up to the order of f32 operations."""
    af, uf = a.float(), u.float()
    if h0 is not None:
        uf = torch.cat([uf[:, :1] + af[:, :1] * h0.float()[:, None], uf[:, 1:]],
                       dim=1)
    d = 1
    while d < a.shape[1]:
        uf = torch.cat([uf[:, :d], af[:, d:] * uf[:, :-d] + uf[:, d:]], dim=1)
        af = torch.cat([af[:, :d], af[:, :-d] * af[:, d:]], dim=1)
        d *= 2
    return uf.to(u.dtype), uf[:, -1]


def rglru_scan_bwd_ref(a, h_prev, dh_seq, dh_final=None):
    """The gradient of the recurrence, the reverse loop in f32:

        g_{S-1} = dh_seq_{S-1} + dh_final,   g_t = dh_seq_t + a_{t+1} g_{t+1}
        du_t = g_t,   da_t = g_t h_{t-1},   dh0 = a_0 g_0

    a, dh_seq: (B, S, R); h_prev: (B, S, R) f32, the state entering each step
    (h0 or zeros, then h_0 .. h_{S-2}); dh_final: (B, R) f32 or None.
    Returns (da, du) in a's dtype and dh0 (B, R) f32.  Each step is one
    rounded f32 sum and one rounded product, in that order, as in
    ``rglru_scan_ref``."""
    af, dhf = a.float(), dh_seq.float()
    carry = torch.zeros_like(af[:, 0]) if dh_final is None else dh_final.float()
    da, du = torch.empty_like(af), torch.empty_like(af)
    for t in reversed(range(a.shape[1])):
        g = dhf[:, t] + carry
        du[:, t] = g
        da[:, t] = g * h_prev[:, t]
        carry = af[:, t] * g
    return da.to(a.dtype), du.to(a.dtype), carry
