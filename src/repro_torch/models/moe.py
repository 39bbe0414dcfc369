"""Mixture-of-Experts layer (``repro/models/moe.py``; DeepSeekMoE-style:
shared + routed top-k).

Dispatch is sort-based with fixed per-expert capacity, row by row: each
batch row sorts its S·K (token, expert) assignments by expert id (a stable
sort, as ``jnp.argsort``), positions beyond capacity are dropped, the expert
FFNs run as one batched product over the (E, B·cap, D) buffer, and the
outputs come back weighted by the router's gates.  The reference computes
the layer outside any Pallas kernel, so the port does too, in PyTorch.

Two choices keep the port's results those of the reference where PyTorch
would differ: the top k experts are taken by a stable descending sort, so
among equal probabilities the lower expert index wins, as in
``jax.lax.top_k`` (``torch.topk`` promises no order); and each token's K
contributions are gathered back into token order and summed there (one f32
accumulation, rounded once), where the reference scatter-adds them in the
order of the sort.  In f32 the two orders of sum differ by rounding alone;
on the card the sum is deterministic, where an atomic ``index_add_`` into
(B, S, D) is not.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from .layers import _act, mlp_apply, mlp_defs
from .params import ParamDef


def moe_defs(cfg: ArchConfig):
    D, E, F = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    d = {
        "router": ParamDef((D, E), fan_in=D),
        "w_in": ParamDef((E, D, F), fan_in=D),
        "w_gate": ParamDef((E, D, F), fan_in=D),
        "w_out": ParamDef((E, F, D), fan_in=F),
    }
    if cfg.n_shared_experts:
        d["shared"] = mlp_defs(cfg, d_ff=cfg.n_shared_experts * cfg.expert_d_ff)
    return d


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, largest first,
    the lower index first among equals (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def route(p, x, cfg: ArchConfig):
    """Router logits in the compute dtype, then f32 softmax and top-k; the
    gates renormalised over the k chosen.  Returns (gates, experts), each
    (..., K)."""
    logits = (x @ p["router"].to(x.dtype)).float()
    gates, experts = top_k(torch.softmax(logits, dim=-1), cfg.top_k)
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), experts


def capacity(cfg: ArchConfig, S: int) -> int:
    """Slots per expert for a row of S tokens."""
    return int(max(1, (S * cfg.top_k / cfg.n_experts) * cfg.capacity_factor))


def positions(experts: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Each assignment's place in its expert's queue, (B, S, K) for
    ``experts`` (B, S, K): the assignments of a row in token-major,
    slot-minor order, stably sorted by expert, numbered from 0 within each
    expert.  An assignment is kept when its place is below the capacity."""
    B, S, K = experts.shape
    e_flat = experts.reshape(B, S * K)
    order = torch.argsort(e_flat, dim=1, stable=True)
    counts = torch.zeros((B, n_experts), dtype=torch.long,
                         device=experts.device)
    counts.scatter_add_(1, e_flat, torch.ones_like(e_flat))
    seg_start = counts.cumsum(1) - counts
    pos_sorted = torch.arange(S * K, device=experts.device)[None, :] \
        - seg_start.gather(1, e_flat.gather(1, order))
    return torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted) \
        .reshape(B, S, K)


def _experts_ffn(p, buf, act: str):
    """buf (E, N, D) through each expert's gated FFN -> (E, N, D)."""
    dt = buf.dtype
    h = _act(torch.bmm(buf, p["w_in"].to(dt)), act) \
        * torch.bmm(buf, p["w_gate"].to(dt))
    return torch.bmm(h, p["w_out"].to(dt))


def moe_apply(p, x, cfg: ArchConfig):
    """x: (B, S, D) -> (B, S, D); decode (S == 1) takes the oracle, which
    drops nothing, as in the reference."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    if S == 1:
        return moe_apply_oracle(p, x, cfg)
    cap = capacity(cfg, S)
    gates, experts = route(p, x, cfg)  # (B, S, K)
    pos = positions(experts, E)
    keep = pos < cap
    slot = (experts * cap + pos.clamp(max=cap - 1)).reshape(B, S * K)
    # row b's slot s is row b * E * cap + s of the flat buffer; a dropped
    # assignment adds zeros to its expert's last slot, as in the reference
    rows = slot + torch.arange(B, device=x.device)[:, None] * (E * cap)
    src = torch.where(keep[..., None], x[:, :, None, :], 0).reshape(B * S * K, D)
    buf = torch.zeros((B * E * cap, D), dtype=x.dtype, device=x.device) \
        .index_add(0, rows.reshape(-1), src)
    buf = buf.reshape(B, E, cap, D).transpose(0, 1).reshape(E, B * cap, D)
    out = _experts_ffn(p, buf, cfg.act)
    out = out.reshape(E, B, cap, D).transpose(0, 1).reshape(B * E * cap, D)
    contrib = out.index_select(0, rows.reshape(-1)).reshape(B, S, K, D) \
        * (gates * keep).to(x.dtype)[..., None]
    y = contrib.sum(2)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, cfg)
    return y


def moe_apply_oracle(p, x, cfg: ArchConfig):
    """Per-token dense oracle (no capacity drops): every expert for every
    token, then the chosen K, weighted by their gates."""
    B, S, D = x.shape
    xf = x.reshape(-1, D)
    gates, experts = route(p, xf, cfg)  # (N, K)
    E = cfg.n_experts
    all_out = _experts_ffn(p, xf[None].expand(E, -1, -1), cfg.act)  # (E, N, D)
    sel = all_out.transpose(0, 1).gather(
        1, experts[..., None].expand(-1, -1, D))  # (N, K, D)
    y = (sel * gates[..., None].to(x.dtype)).sum(1).reshape(B, S, D)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], x, cfg)
    return y
