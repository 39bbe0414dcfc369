"""Roofline synthesis (``repro/launch/roofline.py``): combine dry-run
artifacts (per-device FLOPs + collective bytes, ``launch.trace_analysis``)
with an analytic HBM-traffic model and analytic MODEL_FLOPS.

Why analytic memory: the dry run traces fake tensors, so it sees no memory
traffic at all; the analytic model counts what crosses the card's HBM per
step, the reference's formulas unchanged:

 train:  params f32 read (fwd+bwd) + grad write + Adam m/v read+write +
         param write  (= 32·P_dev bytes)  + remat-boundary activations
         (write fwd, read bwd + recompute rw ≈ 6·L·B·S·D·bf16)  + CE logits
         chunk traffic + token embedding reads.
 prefill: params read + activations once + cache write.
 decode:  params read + full KV-cache/state read + one-slot write
          (the classic bandwidth-bound regime).

MODEL_FLOPS = 6·N·D (dense; N_active for MoE) + 12·L·S²·d_attn causal
attention term for the ratio against the counted FLOPs.

The constants are the NVIDIA H100 SXM's (the card the port runs on, an
NVIDIA H100 80GB HBM3 at a 700.00 W limit): dense bf16 tensor-core rate and
HBM3 bandwidth from NVIDIA's datasheet, NVLink 4's 900 GB/s as 450 GB/s in
each direction, and the memory that ``nvidia-smi --query-gpu=memory.total``
reports for that card (81559 MiB).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..models import lm
from ..models.params import flatten

PEAK_FLOPS = 989.4e12  # dense bf16, tensor cores
HBM_BW = 3.35e12  # bytes/s, HBM3
ICI_BW = 450e9  # bytes/s each way, NVLink 4
HBM_BYTES = 81559 * 2 ** 20


def active_params(cfg: ArchConfig) -> int:
    """Parameters touched per token (MoE: shared + top-k routed experts)."""
    total = lm.num_params(cfg)
    if not cfg.moe:
        return total
    n_moe_layers = cfg.n_layers - cfg.first_dense_layers
    per_expert = 3 * cfg.d_model * cfg.expert_d_ff
    inactive = n_moe_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return total - inactive


def attention_flops_per_layer(cfg: ArchConfig, S: int, B: int) -> float:
    """Causal self-attention matmul FLOPs per layer (2·QK + 2·PV halved for
    causality)."""
    if cfg.ssm:
        # SSD: intra-chunk "attention" within chunk Q + state updates
        d_inner = cfg.ssm_expand * cfg.d_model
        q = cfg.ssd_chunk
        return 2.0 * B * S * (q * d_inner + 2 * d_inner * cfg.ssm_state)
    hd, H = cfg.hd, cfg.n_heads
    window = cfg.local_window if cfg.attn_kind == "local" else None
    n_attn = sum(1 for k in lm.layer_kinds(cfg) if k not in ("ssm", "rglru"))
    frac = n_attn / max(cfg.n_layers, 1)
    eff_S = min(S, window) if window else S
    return frac * 2.0 * B * S * eff_S * H * hd * 2 * 0.5


def model_flops(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """Analytic useful FLOPs per step (global, fwd+bwd for train)."""
    B, S = shape.batch, shape.seq
    n_act = active_params(cfg)
    if shape.kind == "train":
        dense = 6.0 * n_act * B * S
        attn = 3.0 * attention_flops_per_layer(cfg, S, B) * cfg.n_layers
        return dense + attn
    if shape.kind == "prefill":
        dense = 2.0 * n_act * B * S
        attn = attention_flops_per_layer(cfg, S, B) * cfg.n_layers
        return dense + attn
    # decode: one token; attention is a matvec over the cache
    dense = 2.0 * n_act * B
    if cfg.ssm:
        d_inner = cfg.ssm_expand * cfg.d_model
        attn = 4.0 * B * d_inner * cfg.ssm_state * cfg.n_layers
    else:
        window = cfg.local_window if cfg.attn_kind == "local" else None
        eff_S = min(S, window) if window else S
        n_attn = sum(1 for k in lm.layer_kinds(cfg)
                     if k not in ("ssm", "rglru"))
        attn = 4.0 * B * eff_S * cfg.n_heads * cfg.hd * n_attn
    return dense + attn


def cache_bytes(cfg: ArchConfig, batch: int, ctx: int) -> int:
    """Bytes of the decode cache (``lm.cache_defs``: the compute dtype, or a
    leaf's own)."""
    itemsize = lambda d: torch.empty(  # noqa: E731
        (), dtype=getattr(torch, d.dtype or cfg.compute_dtype)).element_size()
    return sum(math.prod(d.shape) * itemsize(d)
               for d in flatten(lm.cache_defs(cfg, batch, ctx)).values())


def analytic_memory_bytes(cfg: ArchConfig, shape: ShapeSpec,
                          n_chips: int) -> float:
    """Per-device HBM bytes per step (the card's model, see module doc)."""
    B, S = shape.batch, shape.seq
    P_dev = lm.num_params(cfg) / n_chips
    act_dev = cfg.n_layers * B * S * cfg.d_model * 2 / n_chips  # bf16
    if shape.kind == "train":
        param_traffic = 32.0 * P_dev
        act_traffic = 6.0 * act_dev
        # chunked CE keeps logits tiles fused; HBM sees the hidden
        # states + embedding rows, not the (B,S,V) logits
        ce = 6.0 * B * S * cfg.d_model / n_chips
        return param_traffic + act_traffic + ce
    if shape.kind == "prefill":
        return 4.0 * P_dev + 2.0 * act_dev + cache_bytes(cfg, B, S) / n_chips
    # decode
    return 4.0 * P_dev + 1.5 * cache_bytes(cfg, B, S) / n_chips


def roofline_row(cell: Dict, cfg: ArchConfig, shape: ShapeSpec) -> Dict:
    n_chips = cell.get("n_chips", 256)
    t_comp = cell.get("hlo_flops", 0.0) / PEAK_FLOPS
    mem = analytic_memory_bytes(cfg, shape, n_chips)
    t_mem = mem / HBM_BW
    t_coll = cell.get("collective_bytes", 0) / ICI_BW
    mf = model_flops(cfg, shape)
    mf_dev = mf / n_chips
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    bottleneck = max(terms, key=terms.get)
    t_bound = max(terms.values())
    # roofline fraction: useful work rate vs peak, at the bound implied time
    mfu_bound = mf_dev / PEAK_FLOPS / max(t_bound, 1e-12)
    return {
        "arch": cell["arch"], "shape": cell["shape"], "mesh": cell["mesh"],
        "t_compute_s": t_comp, "t_memory_s": t_mem, "t_collective_s": t_coll,
        "bottleneck": bottleneck,
        "model_flops_global": mf,
        "hlo_flops_dev": cell.get("hlo_flops", 0.0),
        "useful_ratio": mf_dev / max(cell.get("hlo_flops", 0.0), 1e-9),
        "roofline_frac": min(mfu_bound, 1.0),
        "mem_bytes_dev": mem,
        "coll_bytes_dev": cell.get("collective_bytes", 0),
    }
