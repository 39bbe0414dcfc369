"""Plain f32 reference of a Mamba2 decoder (mamba2-780m:
state-spaces/mamba2-780m).

Each layer: x += out(gated_rmsnorm(ssd(conv(in(rmsnorm(x)))), z)).  The
input projections give z, x, B, C and dt; x, B and C pass a causal
depthwise conv of width W with a bias, then SiLU; dt = softplus(dt + bias);
A = -exp(A_log).  The state space model, per head,

    h_t = exp(A dt_t) h_{t-1} + dt_t x_t B_t^T,    y_t = h_t C_t + D x_t,

is computed in its chunked form (the Mamba2 paper's: within a chunk of Q
steps the masked C B^T product, across chunks the states passed on), each
product of two operands.  The output is rmsnorm(y * silu(z)) over the
whole inner width (one group), then the out projection.

The vocabulary is the published one padded to a multiple of 16 (50,288),
as the published config's pad_vocab_size_multiple says.  Departure from the
published model, as the program has it: the norms are a plain RMSNorm with
eps 1e-6.  The benchmark's weights follow the published initialisation
of dt: dt_bias = softplus^-1(dt), dt log-uniform in [1e-3, 0.1].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._common import ein, mm, quantize, rmsnorm


def _dims(c: dict):
    d_inner = c["ssm_expand"] * c["d_model"]
    H = d_inner // c["ssm_headdim"]
    G, N = c["ssm_groups"], c["ssm_state"]
    return d_inner, H, G, N, d_inner + 2 * G * N


def layout(c: dict) -> list:
    """(key, shape, init, fan_in) of every parameter."""
    D, V, L, W = c["d_model"], c["vocab"], c["n_layers"], c["conv_width"]
    d_inner, H, G, N, conv_ch = _dims(c)
    s = "dec/stack/b0/ssm/"
    return [
        ("embed", (V, D), "normal", D),
        ("final_norm", (D,), "ones", None),
        ("dec/stack/b0/ln1", (L, D), "ones", None),
        (s + "wz", (L, D, d_inner), "normal", D),
        (s + "wx", (L, D, d_inner), "normal", D),
        (s + "wB", (L, D, G * N), "normal", D),
        (s + "wC", (L, D, G * N), "normal", D),
        (s + "wdt", (L, D, H), "normal", D),
        (s + "dt_bias", (L, H), "dt_bias", None),
        (s + "conv_w", (L, W, conv_ch), "normal", W),
        (s + "conv_b", (L, conv_ch), "zeros", None),
        (s + "A_log", (L, H), "a_log", None),
        (s + "D", (L, H), "ones", None),
        (s + "norm", (L, d_inner), "ones", None),
        (s + "out", (L, d_inner, D), "normal", d_inner),
    ]


def causal_conv(u, w, b):
    """Depthwise over the sequence: y_t = b + sum_i w_i u_{t - W + 1 + i},
    zeros before the first step.  u (B, S, C), w (W, C)."""
    W, S = w.shape[0], u.shape[1]
    padded = F.pad(u, (0, 0, W - 1, 0))
    return b + sum(padded[:, i:i + S] * w[i] for i in range(W))


def ssd(x, dt, A, Bm, Cm, D, Q: int, precision: str):
    """x (b, s, h, p), dt (b, s, h), A and D (h,), Bm and Cm (b, s, g, n);
    s a multiple of Q.  Returns (y (b, s, h, p), the final state
    (b, h, p, n))."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    r, nc = h // g, s // Q
    X = (x * dt[..., None]).reshape(b, nc, Q, h, p)
    cum = (A * dt).reshape(b, nc, Q, h).cumsum(2)  # log decay from chunk start
    Bc = Bm.reshape(b, nc, Q, g, n)
    Cc = Cm.reshape(b, nc, Q, g, n)
    # within a chunk: y_l = sum_{j <= l} (C_l . B_j) exp(cum_l - cum_j) X_j
    CB = ein("bclgn,bcjgn->bcglj", Cc, Bc, precision) \
        .repeat_interleave(r, dim=2)
    ch = cum.transpose(2, 3)  # (b, nc, h, Q)
    keep = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = (ch[..., :, None] - ch[..., None, :]).masked_fill(~keep, float("-inf"))
    y = ein("bchlj,bcjhp->bclhp", CB * torch.exp(seg), X, precision)
    # each chunk's contribution to the state at its end
    Bh = Bc.repeat_interleave(r, dim=3)  # (b, nc, Q, h, n)
    to_end = torch.exp(cum[:, :, -1:, :] - cum)[..., None]
    states = ein("bcjhn,bcjhp->bchpn", Bh * to_end, X, precision)
    # the states passed across chunks
    decay = torch.exp(cum[:, :, -1, :])[..., None, None]  # (b, nc, h, 1, 1)
    state = x.new_zeros(b, h, p, n)
    entering = []
    for ci in range(nc):
        entering.append(state)
        state = state * decay[:, ci] + states[:, ci]
    h_in = torch.stack(entering, 1)  # (b, nc, h, p, n)
    Ch = Cc.repeat_interleave(r, dim=3)
    y = y + ein("bclhn,bchpn->bclhp", Ch, h_in, precision) \
        * torch.exp(cum)[..., None]
    return y.reshape(b, s, h, p) + x * D[:, None], state


def block(p, x, c: dict, precision: str):
    """One layer: returns (x, the layer's cache: the last W - 1 inputs of
    the conv and the final state)."""
    B, S, _ = x.shape
    d_inner, H, G, N, _ = _dims(c)
    P, W = c["ssm_headdim"], c["conv_width"]
    hn = rmsnorm(x, p["ln1"], c["norm_eps"])
    z = mm(hn, p["ssm/wz"], precision)
    u = torch.cat([mm(hn, p["ssm/wx"], precision),
                   mm(hn, p["ssm/wB"], precision),
                   mm(hn, p["ssm/wC"], precision)], dim=-1)
    dt = F.softplus(mm(hn, p["ssm/wdt"], precision) + p["ssm/dt_bias"])
    cu = F.silu(causal_conv(u, p["ssm/conv_w"], p["ssm/conv_b"]))
    xc = cu[..., :d_inner].reshape(B, S, H, P)
    Bm = cu[..., d_inner:d_inner + G * N].reshape(B, S, G, N)
    Cm = cu[..., d_inner + G * N:].reshape(B, S, G, N)
    y, state = ssd(xc, dt, -torch.exp(p["ssm/A_log"]), Bm, Cm, p["ssm/D"],
                   c["ssd_chunk"], precision)
    y = rmsnorm(y.reshape(B, S, d_inner) * F.silu(z), p["ssm/norm"],
                c["norm_eps"])
    x = quantize(x + mm(y, p["ssm/out"], precision), precision)
    conv = F.pad(u, (0, 0, max(0, W - 1 - S), 0))[:, -(W - 1):]
    return x, {"conv": conv, "state": state}
