"""Plain f32 reference of a mixture-of-experts decoder
(granite-moe-3b-a800m: ibm-granite/granite-3.0-3b-a800m-base).

Each layer: x += attention(rmsnorm(x)); x += moe(rmsnorm(x)).  Attention is
GQA with RoPE on the two halves of each head.  The router's softmax over
all experts picks the top k (the lower index first among equal
probabilities), and the k gates are renormalised to sum to one.  Each
expert is act(x W_in) * (x W_gate) then W_out.

Departures from the published model, as the program has them: no scalar
multipliers (embedding, attention, residual, logits), and a fixed capacity
per expert and batch row, int(S k / E * capacity_factor): a row's (token,
slot) assignments queue at their expert in token order, then slot order,
and those past the capacity are dropped (their gate counts as zero, the
others are not renormalised again).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._common import causal_attention, ein, mm, quantize, rmsnorm, rope


def _hd(c: dict) -> int:
    return c.get("head_dim") or c["d_model"] // c["n_heads"]


def layout(c: dict) -> list:
    """(key, shape, init, fan_in) of every parameter."""
    D, V, L = c["d_model"], c["vocab"], c["n_layers"]
    H, KH, hd = c["n_heads"], c["n_kv_heads"], _hd(c)
    E, Fe = c["n_experts"], c["expert_d_ff"]
    s = "dec/stack/b0/"
    return [
        ("embed", (V, D), "normal", D),
        ("final_norm", (D,), "ones", None),
        (s + "ln1", (L, D), "ones", None),
        (s + "attn/wq", (L, D, H, hd), "normal", D),
        (s + "attn/wk", (L, D, KH, hd), "normal", D),
        (s + "attn/wv", (L, D, KH, hd), "normal", D),
        (s + "attn/wo", (L, H, hd, D), "normal", H * hd),
        (s + "ln2", (L, D), "ones", None),
        (s + "moe/router", (L, D, E), "normal", D),
        (s + "moe/w_in", (L, E, D, Fe), "normal", D),
        (s + "moe/w_gate", (L, E, D, Fe), "normal", D),
        (s + "moe/w_out", (L, E, Fe, D), "normal", Fe),
    ]


def _act(x, kind: str):
    return F.silu(x) if kind == "silu" else F.gelu(x, approximate="tanh")


def moe(p, x, c: dict, precision: str):
    """x (B, S, D) -> (B, S, D)."""
    B, S, D = x.shape
    E, K = c["n_experts"], c["top_k"]
    probs = torch.softmax(mm(x, p["moe/router"], precision), dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = order.values[..., :K]
    experts = order.indices[..., :K]  # (B, S, K)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    cap = int(max(1, (S * K / E) * c["capacity_factor"]))
    flat = experts.reshape(B, S * K)
    queue = F.one_hot(flat, E).cumsum(1).gather(2, flat[..., None])[..., 0] - 1
    kept = (queue < cap).reshape(B, S, K)
    weight = gates * kept
    xs = x.reshape(B * S, D)
    y = torch.zeros_like(xs)
    for e in range(E):
        chosen = (experts == e) & kept  # a token picks an expert at most once
        rows = chosen.any(-1).reshape(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        w = (weight * chosen).sum(-1).reshape(-1)[rows]
        h = xs[rows]
        h = _act(mm(h, p["moe/w_in"][e], precision), c["act"]) \
            * mm(h, p["moe/w_gate"][e], precision)
        y = y.index_add(0, rows, mm(h, p["moe/w_out"][e], precision)
                        * w[:, None])
    return y.reshape(B, S, D)


def block(p, x, c: dict, precision: str):
    """One layer: returns (x, the layer's cache: RoPE'd keys and values)."""
    h = rmsnorm(x, p["ln1"], c["norm_eps"])
    q = rope(ein("bsd,dhk->bshk", h, p["attn/wq"], precision), c["rope_theta"])
    k = rope(ein("bsd,dhk->bshk", h, p["attn/wk"], precision), c["rope_theta"])
    v = ein("bsd,dhk->bshk", h, p["attn/wv"], precision)
    o = causal_attention(q, k, v, precision)
    x = quantize(x + ein("bshk,hkd->bsd", o, p["attn/wo"], precision),
                 precision)
    x = quantize(x + moe(p, rmsnorm(x, p["ln2"], c["norm_eps"]), c,
                         precision), precision)
    return x, {"k": k, "v": v}
