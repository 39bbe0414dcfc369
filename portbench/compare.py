"""The numbers that decide ``correct``: what the program produced against
what the plain reference computes from the same inputs.

Training (the first steps of the run, which set-up drives through the
window's own call and feed; and, prefixed ``late_``, the steps after the
window, from the program's state as the window left it):
    loss_gap    the widest |program - reference| / |reference| of a step's
                loss;
    grad_gap    over the parameters, the widest gap between the norms of the
                first gradient as the optimizer took it (the program's from
                its first moment after one step, m / (1 - b1)),
                |program - reference| / max(reference, the median
                parameter's reference);
    change_gap  the same of the parameters' change over the checked steps,
                leaving out a parameter whose reference gradient is under a
                thousandth of the median parameter's (round-off moves it).
Prefill (a sample of the window's requests):
    logit_gap_mean    the mean over the sampled requests of the amount by
                      which the reference's logit of the served first token
                      lies below the reference's largest;
    cache_err_median  the median over layers and entries (keys, values; the
                      conv window, the state) of |program - reference| /
                      |reference| of one layer's entry;
    cache_err_max     the worst of those: no layer's cache may be wrong.
The mean gap is steady from seed to seed where the widest gap swings with
the few tokens whose experts a rounding flips (PERF.md).
"""
from __future__ import annotations

import math
import statistics

import torch

SILENT_GRAD = 1e-3  # of the median parameter's first-gradient norm


def _gap(p: float, r: float, floor: float) -> float:
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / max(abs(r), floor)


def train(prog: dict, ref: dict) -> dict:
    losses = [_gap(p, r, 0.0) for p, r in zip(prog["losses"], ref["losses"])]
    g_ref = ref["grad_norms"]
    med_g = statistics.median(g_ref.values())
    moved = [k for k in g_ref if g_ref[k] >= SILENT_GRAD * med_g]
    c_ref = ref["change_norms"]
    med_c = statistics.median(c_ref[k] for k in moved)
    return {
        "loss_gap": max(losses),
        "grad_gap": max(_gap(prog["grad_norms"][k], g_ref[k], med_g)
                        for k in g_ref),
        "change_gap": max(_gap(prog["change_norms"][k], c_ref[k], med_c)
                          for k in moved),
    }


def served_gaps(ref_logits: torch.Tensor, served) -> torch.Tensor:
    """(B,) how far below the reference's best each served token lies."""
    tok = torch.as_tensor(served, device=ref_logits.device).long()
    bad = (tok < 0) | (tok >= ref_logits.shape[-1])
    gold = ref_logits.gather(-1, tok.clamp(0, ref_logits.shape[-1] - 1)[:, None])
    gap = ref_logits.max(-1).values - gold[:, 0]
    return torch.where(bad, torch.full_like(gap, math.inf), gap)


def cache_errors(prog: dict, ref: dict) -> list:
    """Per key and layer, the relative error of the program's cache entry
    (cut to the reference's extent: a cache longer than the prompt holds
    empty slots) against the reference's."""
    errs = []
    for key, r in ref.items():
        p = prog[key]
        p = p[tuple(slice(0, n) for n in r.shape)].to(r.device).float()
        if p.shape != r.shape:  # a cache of fewer rows than the batch
            errs += [math.inf] * r.shape[0]
            continue
        for layer in range(r.shape[0]):
            num = torch.linalg.vector_norm(p[layer] - r[layer])
            den = torch.linalg.vector_norm(r[layer]).clamp_min(1e-30)
            errs.append(float(num / den))
    return errs
