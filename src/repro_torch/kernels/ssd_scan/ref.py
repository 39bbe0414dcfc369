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

The gradient (``ssd_bwd_ref``) is written from its formulas, in the split of
the backward kernels: ``chunk_dstate_ref`` (each chunk's gradient of its
incoming state through the carry), ``state_pass_bwd_ref`` (the reverse scan
over the chunks) and ``chunk_bwd_ref`` (every input's gradient, chunk by
chunk).

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


def _causal_decay(cumf):
    """L[q, k] = exp(cum_q - cum_k) for k <= q, else 0, as (Bt, nc, H, Q, K)
    from cum (Bt, nc, Q, H); masked before the exp."""
    Q = cumf.shape[2]
    cum_h = cumf.permute(0, 1, 3, 2)
    diff = cum_h[..., :, None] - cum_h[..., None, :]
    mask = torch.ones(Q, Q, dtype=torch.bool, device=cumf.device).tril()
    return torch.exp(torch.where(mask, diff, float("-inf")))


def chunk_dstate_ref(dy, cum, C, *, chunk: int):
    """The gradient of each chunk's incoming state through its carry, f32:

        dS_c = sum_q exp(cum_q) dy_q (outer) C_q

    dy: (Bt, S, H, P); cum: (Bt, S, H) f32; C: (Bt, S, G, N).  Returns
    (Bt, nc, H, P, N) f32."""
    Bt, S, H, P = dy.shape
    G, N = C.shape[2], C.shape[3]
    nc = S // chunk
    dyw = (dy.float() * torch.exp(cum)[..., None]).reshape(
        Bt, nc, chunk, G, H // G, P)
    return torch.einsum("bcqgrp,bcqgn->bcgrpn", dyw,
                        C.float().reshape(Bt, nc, chunk, G, N)).reshape(
        Bt, nc, H, P, N)


def state_pass_bwd_ref(dS, cum, h_ins, dh_final=None, *, chunk: int):
    """The reverse scan over the chunks: with dh_in[nc] = dh_final (or 0),

        dh_in[c] = dS_c + exp(cum_end[c]) dh_in[c + 1]

    dS, h_ins: (Bt, nc, H, P, N) f32; cum: (Bt, S, H) f32.  Returns
    (dchunk_in (Bt, nc, H, P, N), the gradient of each chunk's input to the
    state, dh_in[c + 1]; dh0 = dh_in[0] (Bt, H, P, N); and the chunk-end
    term exp(cum_end[c]) <h_in[c], dh_in[c + 1]> (Bt, nc, H), the gradient
    of cum at each chunk's last row through the state's decay), all f32.
    The multiply and the add round separately, in that order."""
    decay = torch.exp(cum[:, chunk - 1::chunk])  # (Bt, nc, H)
    g = torch.zeros_like(dS[:, 0]) if dh_final is None else dh_final.float()
    dchunk_in = torch.empty_like(dS)
    end = torch.empty_like(decay)
    for c in reversed(range(dS.shape[1])):
        dchunk_in[:, c] = g
        end[:, c] = decay[:, c] * (h_ins[:, c] * g).sum((-2, -1))
        g = dS[:, c] + decay[:, c, :, None, None] * g
    return dchunk_in, g, end


def chunk_bwd_ref(x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in, end_term, *,
                  chunk: int, dA_scale: bool = False):
    """Every input's gradient, chunk by chunk, in f32.  Per (batch, head,
    chunk), rows q >= k of the chunk, with L_qk = exp(cum_q - cum_k),
    s_qk = C_q . B_k, w_k = exp(cum_end - cum_k) dt_k and Dc = dchunk_in:

        dx_k = dt_k sum_{q>=k} s_qk L_qk dy_q + w_k (Dc B_k) + D dy_k
        dC_q = sum_{k<=q} L_qk dt_k (dy_q . x_k) B_k + exp(cum_q) h_in^T dy_q
        dB_k = sum_{q>=k} L_qk dt_k (dy_q . x_k) C_q + w_k Dc^T x_k

    (dB and dC summed over the heads of a group); dt's gradient through the
    scores, through w and through cum; cum's through L, w, the carry's
    exp(cum_q) and ``end_term`` (the state's decay, at each chunk's last
    row), then its reverse cumsum within the chunk, which is the gradient of
    A.dt.  x, dy: (Bt, S, H, P); dt, cum: (Bt, S, H) f32; A, D: (H,);
    B, C: (Bt, S, G, N); h_ins, dchunk_in: (Bt, nc, H, P, N) f32; end_term:
    (Bt, nc, H) f32.  Returns (dx, ddt, dA, dB, dC, dD), all f32, and with
    ``dA_scale`` also sum |dt . rc| (H,), the magnitude of dA's terms: dA sums
    them over every row of the sequence, and their f32 rounding scales with
    it, not with dA."""
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    R, nc, Q = H // G, S // chunk, chunk
    xf = x.float().reshape(Bt, nc, Q, H, P)
    dyf = dy.float().reshape(Bt, nc, Q, H, P)
    dtf = dt.float().reshape(Bt, nc, Q, H)
    cumf = cum.float().reshape(Bt, nc, Q, H)
    Bf = B.float().reshape(Bt, nc, Q, G, N)
    Cf = C.float().reshape(Bt, nc, Q, G, N)
    by_group = (Bt, nc, G, R)

    # the intra-chunk term, with (q, k) matrices (Bt, nc, H, Q, K)
    L = _causal_decay(cumf)
    s = torch.einsum("bcqgn,bckgn->bcgqk", Cf, Bf)
    s = s[:, :, :, None].expand(*by_group, Q, Q).reshape(Bt, nc, H, Q, Q)
    dt_k = dtf.permute(0, 1, 3, 2)[..., None, :]
    gm = torch.einsum("bcqhp,bckhp->bchqk", dyf, xf)  # dy_q . x_k
    dx = torch.einsum("bchqk,bcqhp->bckhp", s * L * dt_k, dyf)
    e = s * L * gm
    ddt = e.sum(-2).permute(0, 1, 3, 2)  # over q
    m = e * dt_k
    dcum = (m.sum(-1) - m.sum(-2)).permute(0, 1, 3, 2)  # (Bt, nc, Q, H)
    dcb = (L * dt_k * gm).reshape(*by_group, Q, Q).sum(3)
    dC = torch.einsum("bcgqk,bckgn->bcqgn", dcb, Bf)
    dB = torch.einsum("bcgqk,bcqgn->bckgn", dcb, Cf)

    # each chunk's input to the state
    decay_end = torch.exp(cumf[:, :, -1:] - cumf)  # (Bt, nc, Q, H)
    w = dtf * decay_end
    Dc = dchunk_in.reshape(*by_group, P, N)
    dcb_k = torch.einsum("bcgrpn,bckgn->bckgrp", Dc, Bf).reshape(Bt, nc, Q, H, P)
    dx = dx + w[..., None] * dcb_k
    dw = (xf * dcb_k).sum(-1)
    xdc = torch.einsum("bckgrp,bcgrpn->bckgrn", xf.reshape(Bt, nc, Q, G, R, P),
                       Dc)
    dB = dB + (w.reshape(Bt, nc, Q, G, R)[..., None] * xdc).sum(4)
    ddt = ddt + decay_end * dw
    dcum = dcum - w * dw
    dcum[:, :, -1] += (w * dw).sum(2) + end_term

    # the carry of the incoming state
    ecum = torch.exp(cumf)
    dyh = torch.einsum("bcqgrp,bcgrpn->bcqgrn", dyf.reshape(Bt, nc, Q, G, R, P),
                       h_ins.reshape(*by_group, P, N))
    dC = dC + (ecum.reshape(Bt, nc, Q, G, R)[..., None] * dyh).sum(4)
    dcum = dcum + ecum * (Cf[:, :, :, :, None] * dyh).sum(-1).reshape(
        Bt, nc, Q, H)

    # cum = cumsum(A.dt) within the chunk: the reverse cumsum
    rc = dcum.flip(2).cumsum(2).flip(2)
    ddt = ddt + A * rc
    dA = (dtf * rc).sum((0, 1, 2))
    dx = dx + D[:, None] * dyf
    dD = (dyf * xf).sum((0, 1, 2, 4))
    grads = (dx.reshape(Bt, S, H, P), ddt.reshape(Bt, S, H), dA,
             dB.reshape(Bt, S, G, N), dC.reshape(Bt, S, G, N), dD)
    return (*grads, (dtf * rc).abs().sum((0, 1, 2))) if dA_scale else grads


def ssd_bwd_ref(x, dt, A, B, C, D, cum, h_ins, dy, dh_final=None, *,
                chunk: int):
    """The gradient of ``ssd_chunked_ref`` from its saved cum and h_ins:
    (dx, ddt, dA, dB, dC, dD, dh0), all f32."""
    dS = chunk_dstate_ref(dy, cum, C, chunk=chunk)
    dchunk_in, dh0, end = state_pass_bwd_ref(dS, cum, h_ins, dh_final,
                                             chunk=chunk)
    return (*chunk_bwd_ref(x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in, end,
                           chunk=chunk), dh0)


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
