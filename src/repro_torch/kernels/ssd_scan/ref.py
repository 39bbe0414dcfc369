"""Mamba2 SSD (state-space duality), plain PyTorch versions
(``repro/kernels/ssd_scan/ref.py``).

``ssd_ref`` is the literal sequential recurrence:

    h_t = exp(A·dt_t) · h_{t-1} + dt_t · B_t ⊗ x_t
    y_t = C_t · h_t + D ⊙ x_t

``ssd_chunked_ref`` is the chunked form: within a chunk the masked,
attention-like C·Bᵀ product and each chunk's input to the state
(``ssd_chunk_ref``, the function of the f32 CUDA kernel, in its layout),
across chunks a state-passing loop (``pass_states``), then the carry of the
incoming state and the D skip.  The bf16 CUDA kernels split the same
function as ``chunk_state_ref``, ``pass_states`` and ``chunk_scan_ref``.

Every product is a two-operand ``einsum`` or ``matmul`` (B and C are read by
group, never repeated to every head): at the serving shape a poor contraction
order of the reference's three- and four-operand einsums would build a
(Bt, nc, Q, K, H, P) intermediate of tens of GB.
"""
from __future__ import annotations

import torch


def _heads(t, H: int):
    """(..., G, N) read by head: (..., H, N), head h taking group h // (H/G)."""
    return t.repeat_interleave(H // t.shape[-2], dim=-2)


def ssd_ref(x, dt, A, B, C, D, h0=None):
    """x: (Bt, S, H, P); dt: (Bt, S, H); A: (H,) (negative); B, C:
    (Bt, S, G, N) with H % G == 0; D: (H,).  Returns (y, h_final) with
    h shape (Bt, H, P, N) in f32."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    Bh, Ch = _heads(B.float(), H), _heads(C.float(), H)
    xf, dtf = x.float(), dt.float()
    h = torch.zeros(Bt, H, P, N, device=x.device) if h0 is None else h0.float()
    ys = []
    for t in range(S):
        a = torch.exp(A * dtf[:, t])  # (Bt, H)
        h = h * a[..., None, None] \
            + (dtf[:, t, :, None] * xf[:, t])[..., None] * Bh[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Ch[:, t]))
    y = torch.stack(ys, dim=1) + xf * D[:, None]
    return y.to(x.dtype), h


def chunk_cumsum(dt, A, chunk: int):
    """f32 cumulative sum of A·dt within each chunk: (Bt, S, H), S % chunk == 0."""
    Bt, S, H = dt.shape
    a = (A * dt.float()).reshape(Bt, S // chunk, chunk, H)
    return torch.cumsum(a, dim=2).reshape(Bt, S, H)


def chunk_intra_ref(x, dt, cum, B, C, *, chunk: int):
    """The intra-chunk term, for each (batch, head, chunk), in f32:

        y_intra[q] = sum_{k<=q} (C_q . B_k) . exp(cum_q - cum_k) . dt_k . x_k

    x: (Bt, S, H, P); dt, cum: (Bt, S, H) f32 (cum the within-chunk cumsum
    of A.dt); B, C: (Bt, S, G, N); S % chunk == 0.  Returns (Bt, S, H, P) f32.
    """
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    R, nc, Q = H // G, S // chunk, chunk
    xf = x.float().reshape(Bt, nc, Q, H, P)
    dtf = dt.float().reshape(Bt, nc, Q, H)
    cumf = cum.float().reshape(Bt, nc, Q, H)
    Bf = B.float().reshape(Bt, nc, Q, G, N)
    Cf = C.float().reshape(Bt, nc, Q, G, N)

    # L[q, k] = exp(cum_q - cum_k) for q >= k.  Mask BEFORE the exp: a masked
    # (q < k) difference is positive and its exp can overflow.
    cum_h = cumf.permute(0, 1, 3, 2)  # (Bt, nc, H, Q)
    diff = cum_h[..., :, None] - cum_h[..., None, :]  # (Bt, nc, H, Q, K)
    mask = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    L = torch.exp(torch.where(mask, diff, float("-inf")))
    cb = torch.einsum("bcqgn,bckgn->bcgqk", Cf, Bf)  # by group, not by head
    scores = (L.reshape(Bt, nc, G, R, Q, Q) * cb[:, :, :, None]).reshape(
        Bt, nc, H, Q, Q) * dtf.permute(0, 1, 3, 2)[..., None, :]
    y = torch.matmul(scores, xf.permute(0, 1, 3, 2, 4))  # (Bt, nc, H, Q, P)
    return y.permute(0, 1, 3, 2, 4).reshape(Bt, S, H, P)


def chunk_state_ref(x, dt, cum, B, *, chunk: int):
    """Each chunk's input to the state (``ssd_chunk_state``'s function), f32:

        chunk_in = sum_k (x_k . dt_k . exp(cum_end - cum_k)) (outer) B_k

    Shapes as ``chunk_intra_ref``.  Returns (Bt, nc, H, P, N) f32."""
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    R, nc, Q = H // G, S // chunk, chunk
    xf = x.float().reshape(Bt, nc, Q, H, P)
    dtf = dt.float().reshape(Bt, nc, Q, H)
    cumf = cum.float().reshape(Bt, nc, Q, H)
    Bf = B.float().reshape(Bt, nc, Q, G, N)
    w = dtf * torch.exp(cumf[:, :, -1:] - cumf)  # (Bt, nc, Q, H), <= dt
    xw = (xf * w[..., None]).reshape(Bt, nc, Q, G, R, P)
    return torch.einsum("bckgrp,bckgn->bcgrpn", xw, Bf).reshape(
        Bt, nc, H, P, N)


def ssd_chunk_ref(x, dt, cum, B, C, *, chunk: int):
    """The f32 CUDA kernel's function (``csrc/ssd_chunk.cu``) in its layout:
    (y_intra (Bt, S, H, P), chunk_in (Bt, nc, H, P, N)), both f32, as
    ``chunk_intra_ref`` and ``chunk_state_ref`` compute them."""
    return (chunk_intra_ref(x, dt, cum, B, C, chunk=chunk),
            chunk_state_ref(x, dt, cum, B, chunk=chunk))


def pass_states(chunk_in, chunk_decay, h0=None):
    """The state entering each chunk, and the final state.

    chunk_in: (Bt, nc, H, P, N) f32; chunk_decay: (Bt, nc, H) = exp(cum_end).
    Returns (h_ins (Bt, nc, H, P, N), h_final (Bt, H, P, N)), f32."""
    h = torch.zeros_like(chunk_in[:, 0]) if h0 is None else h0.float()
    h_ins = []
    for c in range(chunk_in.shape[1]):
        h_ins.append(h)  # the INCOMING state of chunk c
        h = h * chunk_decay[:, c, :, None, None] + chunk_in[:, c]
    return torch.stack(h_ins, dim=1), h


def carry(C, h_ins, cum, *, chunk: int):
    """y_carry[q] = (C_q · h_in) · exp(cum_q), as (Bt, S, H, P) f32."""
    Bt, nc, H, P, N = h_ins.shape
    G = C.shape[2]
    Cf = C.float().reshape(Bt, nc, chunk, G, N)
    y = torch.einsum("bcqgn,bcgrpn->bcqgrp", Cf,
                     h_ins.reshape(Bt, nc, G, H // G, P, N))
    return (y.reshape(Bt, nc * chunk, H, P) * torch.exp(cum)[..., None])


def combine(x, y_intra, C, h_ins, cum, D, *, chunk: int):
    """y = y_intra + carry + D.x, rounded once to x's dtype."""
    y = y_intra + carry(C, h_ins, cum, chunk=chunk) + x.float() * D[:, None]
    return y.to(x.dtype)


def chunk_scan_ref(x, dt, cum, B, C, D, h_ins, *, chunk: int):
    """``ssd_chunk_scan``'s function: y of every chunk from its intra term,
    its incoming state h_ins (Bt, nc, H, P, N) f32 and the D skip, in x's
    dtype."""
    return combine(x, chunk_intra_ref(x, dt, cum, B, C, chunk=chunk), C, h_ins,
                   cum, D, chunk=chunk)


def ssd_chunked_ref(x, dt, A, B, C, D, chunk: int, h0=None):
    """Chunked SSD, same contract as ``ssd_ref``; S % chunk == 0."""
    cum = chunk_cumsum(dt, A, chunk)
    y_intra, chunk_in = ssd_chunk_ref(x, dt.float(), cum, B, C, chunk=chunk)
    h_ins, h_final = pass_states(chunk_in, torch.exp(cum[:, chunk - 1::chunk]),
                                 h0)
    return combine(x, y_intra, C, h_ins, cum, D, chunk=chunk), h_final


def ssd_decode_step(h, x, dt, A, B, C, D):
    """Single-token recurrent update.  h: (Bt, H, P, N) f32; x: (Bt, H, P);
    dt: (Bt, H); B, C: (Bt, G, N).  Returns (y (Bt, H, P), h_new)."""
    H = x.shape[1]
    Bh, Ch = _heads(B.float(), H), _heads(C.float(), H)
    dtf, xf = dt.float(), x.float()
    h = h * torch.exp(A * dtf)[..., None, None] \
        + (dtf[..., None] * xf)[..., None] * Bh[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h, Ch) + xf * D[:, None]
    return y.to(x.dtype), h
