"""RG-LRU (RecurrentGemma) linear recurrence, plain PyTorch versions
(``repro/kernels/rglru_scan/ref.py``).

Given per-step decay a_t ∈ (0, 1) and pre-gated input u_t (the caller forms
u_t = sqrt(1 − a_t²) · i_t ⊙ x_t):

    h_t = a_t · h_{t-1} + u_t

``rglru_scan_ref`` is the sequential f32 loop, the oracle the CUDA kernels
are held against; ``rglru_scan_assoc`` is a log-depth scan, the plain path of
the model (the JAX package's path off the TPU).  ``rglru_scan_bwd_ref`` is the
reverse loop of the gradient, the oracle of the CUDA backward kernels.

``rglru_scan_chunked_ref`` and ``rglru_scan_bwd_chunked_ref`` mirror the
kernels' chunked arithmetic (``csrc/rglru_scan.cu``): the sequence is cut
into chunks of ``chunk`` steps, each chunk is summarised by the product of
its decays and its state walked from zero, the summaries of the chunks
before (after, in the backward) a chunk are composed onto h0 (dh_final), and
the chunk is then walked exactly.  Every f32 product and sum is rounded on
its own, in the kernels' order, so the kernels equal the mirrors to the bit;
at ``chunk >= S`` the mirrors are the sequential oracles, bit for bit.
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


def _chunks(x, chunk, C, pad):
    """(B, S, R) -> (B, C, chunk, R) f32, the tail past S filled with
    ``pad``: a decay of 1 and an addend of -0 leave h unchanged exactly."""
    B, S, R = x.shape
    out = x.float().new_full((B, C * chunk, R), pad)
    out[:, :S] = x.float()
    return out.view(B, C, chunk, R)


def rglru_scan_chunked_ref(a, u, h0, chunk):
    """``rglru_scan_ref`` in the CUDA kernels' order of f32 operations, in
    chunks of ``chunk`` steps (h0 None: zeros).

    For each chunk c but the last, P_c = a_first ... a_last (from 1) and
    H_c the chunk's state walked from 0; then chunk c starts from
    h0 composed with (P_0, H_0) .. (P_{c-1}, H_{c-1}), h <- P h + H, and
    walks its steps as the sequential loop does.  Returns what
    ``rglru_scan_ref`` returns."""
    B, S, R = a.shape
    chunk = max(1, min(chunk, S))
    C = -(-S // chunk)
    af, uf = _chunks(a, chunk, C, 1.0), _chunks(u, chunk, C, -0.0)
    h = torch.zeros(B, R) if h0 is None else h0.float()
    starts = [h.to(af.device)]
    if C > 1:  # the summaries of chunks 0 .. C - 2, all at once
        P = torch.ones_like(af[:, :-1, 0])
        H = torch.zeros_like(af[:, :-1, 0])
        for i in range(chunk):
            P = af[:, :-1, i] * P
            H = af[:, :-1, i] * H + uf[:, :-1, i]
        for c in range(1, C):
            starts.append(P[:, c - 1] * starts[-1] + H[:, c - 1])
    h = torch.stack(starts, dim=1)  # (B, C, R)
    hs = torch.empty_like(af)
    for i in range(chunk):  # every chunk's walk at once
        h = af[:, :, i] * h + uf[:, :, i]
        hs[:, :, i] = h
    hs = hs.view(B, C * chunk, R)[:, :S]
    return hs.to(u.dtype), hs[:, -1].clone()


def rglru_scan_bwd_chunked_ref(a, h_prev, dh_seq, dh_final, chunk):
    """``rglru_scan_bwd_ref`` in the CUDA kernels' order of f32 operations,
    in chunks of ``chunk`` steps (dh_final None: zeros).

    For each chunk c but the first, walked backward from a carry of 0, P_c
    the product of its decays (from 1, last step first) and X_c the carry it
    hands to the chunk before; chunk c starts from dh_final (or 0) composed
    with (P_{C-1}, X_{C-1}) .. (P_{c+1}, X_{c+1}), x <- P x + X, and walks
    its steps backward as the sequential loop does.  Returns what
    ``rglru_scan_bwd_ref`` returns."""
    B, S, R = a.shape
    chunk = max(1, min(chunk, S))
    C = -(-S // chunk)
    af, df = _chunks(a, chunk, C, 1.0), _chunks(dh_seq, chunk, C, -0.0)
    hp = _chunks(h_prev, chunk, C, 0.0)
    x = torch.zeros(B, R) if dh_final is None else dh_final.float()
    carries = [x.to(af.device)]
    if C > 1:  # the summaries of chunks 1 .. C - 1, all at once
        P = torch.ones_like(af[:, 1:, 0])
        X = torch.zeros_like(af[:, 1:, 0])
        for i in reversed(range(chunk)):
            P = af[:, 1:, i] * P
            X = af[:, 1:, i] * (df[:, 1:, i] + X)
        for c in reversed(range(C - 1)):
            carries.append(P[:, c] * carries[-1] + X[:, c])
    x = torch.stack(carries[::-1], dim=1)  # (B, C, R)
    da, du = torch.empty_like(af), torch.empty_like(af)
    for i in reversed(range(chunk)):
        g = df[:, :, i] + x
        du[:, :, i] = g
        da[:, :, i] = g * hp[:, :, i]
        x = af[:, :, i] * g
    da = da.view(B, C * chunk, R)[:, :S]
    du = du.view(B, C * chunk, R)[:, :S]
    return da.to(a.dtype), du.to(a.dtype), x[:, 0].clone()
