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

Under a mesh the dispatch (top k, queue places, the scatter into the
buffer) and the combine (the gather back, weighted by the gates) run on
each rank's rows of the batch (``kernels.shards.on_shards``), as the
reference's row-local dispatch does under GSPMD; the router, the buffer
(constrained to the experts on `model`) and the expert FFNs are DTensors.
"""
from __future__ import annotations

import torch

from ..configs.base import ArchConfig
from ..kernels.shards import Arg, is_dtensor, on_shards
from .layers import _act, mlp_apply, mlp_defs
from .params import ParamDef
from .sharding import constrain, matmul


def moe_defs(cfg: ArchConfig):
    D, E, F = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    d = {
        "router": ParamDef((D, E), ("embed", "experts"), fan_in=D),
        "w_in": ParamDef((E, D, F), ("experts", "embed", "ffn"), fan_in=D),
        "w_gate": ParamDef((E, D, F), ("experts", "embed", "ffn"), fan_in=D),
        "w_out": ParamDef((E, F, D), ("experts", "ffn", "embed"), fan_in=F),
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
    return _gates(_router_logits(p, x), cfg)


def _router_logits(p, x):
    return matmul(x, p["router"].to(x.dtype)).float()


def _gates(logits, cfg: ArchConfig):
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


def _experts_ffn(p, buf, act: str, axes=None):
    """buf (E, N, D) through each expert's gated FFN -> (E, N, D); ``axes``
    constrains the hidden activations."""
    dt = buf.dtype
    h = _act(matmul(buf, p["w_in"].to(dt)), act) \
        * matmul(buf, p["w_gate"].to(dt))
    if axes:
        h = constrain(h, *axes)
    return matmul(h, p["w_out"].to(dt))


def _by_rows(fn, n_out: int, *tensors, features: bool = False):
    """``fn`` on each rank's rows of the batch under a mesh (every tensor's
    dimension 0 is the batch), ``fn`` itself otherwise.  With ``features``
    the first tensor's partial sums are reduced and scattered over its last
    dimension, which ``fn`` keeps as its output's last, rather than summed
    whole on every rank."""
    lead = tensors[0]
    if not is_dtensor(lead):
        return fn(*tensors)
    rows, dims = {"batch": 0}, {"batch": 0}
    if features:
        from torch.distributed.tensor import Partial, Shard
        lead = lead.redistribute(lead.device_mesh, [
            Shard(lead.dim() - 1) if isinstance(p, Partial) else p
            for p in lead.placements])
        dims = {"batch": 0, "features": lead.dim() - 1}
    out_dims = {"batch": 0, "features": 2} if features else rows
    return on_shards(fn, lead, dims, [Arg(lead, dims)] + [
        Arg(t, rows) for t in tensors[1:]], [out_dims] * n_out)


def moe_apply(p, x, cfg: ArchConfig):
    """x: (B, S, D) -> (B, S, D); decode (S == 1) takes the oracle, which
    drops nothing, as in the reference."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    if S == 1:
        return moe_apply_oracle(p, x, cfg)
    cap = capacity(cfg, S)

    def dispatch(x, logits):
        """(buf (B, E, cap, D), each assignment's buffer row, its weight)."""
        B = x.shape[0]
        gates, experts = _gates(logits, cfg)  # (B, S, K)
        pos = positions(experts, E)
        keep = pos < cap
        slot = (experts * cap + pos.clamp(max=cap - 1)).reshape(B, S * K)
        # row b's slot s is row b * E * cap + s of the flat buffer; a dropped
        # assignment adds zeros to its expert's last slot, as in the reference
        rows = slot + torch.arange(B, device=x.device)[:, None] * (E * cap)
        src = torch.where(keep[..., None], x[:, :, None, :], 0) \
            .reshape(B * S * K, D)
        buf = torch.zeros((B * E * cap, D), dtype=x.dtype, device=x.device) \
            .index_add(0, rows.reshape(-1), src)
        return buf.reshape(B, E, cap, D), rows, (gates * keep).to(x.dtype)

    def combine(out, rows, weights):
        B, D = out.shape[0], out.shape[-1]  # D: a shard of it, under a mesh
        contrib = out.reshape(B * E * cap, D).index_select(0, rows.reshape(-1)) \
            .reshape(B, S, K, D) * weights[..., None]
        return contrib.sum(2)

    buf, rows, weights = _by_rows(dispatch, 3, x, _router_logits(p, x))
    buf = constrain(buf, "batch", "experts", None, None)
    out = _experts_ffn(p, buf.transpose(0, 1).reshape(E, B * cap, D), cfg.act,
                       ("experts", "batch", "ffn"))
    y = _by_rows(combine, 1, out.reshape(E, B, cap, D).transpose(0, 1), rows,
                 weights, features=True)
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
