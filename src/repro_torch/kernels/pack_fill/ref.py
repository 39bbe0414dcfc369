"""The packing pass in plain PyTorch: ``pack_all_types_ref``, a line-for-line
transcription of ``repro/core/engine_jax.py::_pack_all_types`` (jitted
``lax``, not Pallas), with Python loops for its ``while_loop``s and the same
arithmetic in the same order.  It is what the port runs on CPU tensors, and
the oracle ``csrc/pack_fill.cu`` is held against.

One pass walks the (masked-in) types in descending cost.  On each type it
greedily fills fresh instances, one *class* of interchangeable tasks at a
time (Algorithm 1's argmax in its incremental form):

    score_c = cur − (agg · Q)[w_c] + rp_c − (1 − exp(logtput_c)) · jobrp_c

with Q = 1 − P, ``agg_w`` the members' Σ jobrp·tput per workload and
``logtput_c`` the candidate's running log-throughput.  A fill stops when the
best feasible score would lower the instance's TNRP; it is kept when its
TNRP reaches the instance cost (less a tolerance of 256 ulps of the cost)
and the type's region has budget, replicated ``rep = min_c ⌊count_c /
used_c⌋`` times (capped by the budget; once, if an add broke an exact
cross-class tie, which falls to the class whose next task row is lowest).
The sum (agg · Q)[w] is taken over w in ascending order, which the kernel
repeats.
"""
from __future__ import annotations

import torch

EPS = 1e-9
NEG = -1e30
BIG_I = 2 ** 30 - 1  # np.iinfo(np.int32).max // 2: headroom for decrements


def pack_all_types_ref(cdemand, cw, crp, cjr, counts0, rows_pad, P, logP,
                       costs, caps, fams, rids, budget, *, max_fills: int):
    """One pass over every type in descending-cost order.

    Shapes: cdemand (C, F, R) · cw, counts0 (C,) int32 · crp, cjr (C,) ·
    rows_pad (C, M) int32 · P, logP (W, W) · costs (K,) · caps (K, R) ·
    fams, rids (K,) int32 · budget (NR,) int32; every float the same dtype.
    Returns (budget, rec_type (max_fills,), rec_rep (max_fills,), rec_comp
    (max_fills, C), n_rec, overflow): the budget left, the fills (type
    position, replication, per-class composition; at most ``max_fills``
    kept), their count and whether some were not kept."""
    C, W, K, M = cw.shape[0], P.shape[0], costs.shape[0], rows_pad.shape[1]
    dt, dev = crp.dtype, crp.device
    cwl = cw.long()
    arange_c = torch.arange(C, device=dev)
    # complement interference matrix: the members' penalty (agg @ Q)[c] is
    # exactly zero when interference is off (P ≡ 1)
    Q = 1.0 - P
    rtol = 256 * torch.finfo(dt).eps  # 2^-15 or 2^-44: exact in dt

    def fill_one(counts, d, cap0):
        """Greedy-fill one fresh instance; returns (used, tnrp, had_tie)."""
        used = torch.zeros(C, dtype=torch.int32, device=dev)
        capr = cap0.clone()
        logtput = torch.zeros(C, dtype=dt, device=dev)
        agg = torch.zeros(W, dtype=dt, device=dev)
        cur = torch.zeros((), dtype=dt, device=dev)
        tie = False
        while True:
            feas = ((counts - used) > 0) & torch.all(
                d <= capr[None, :] + EPS, dim=1)
            cand_tput = torch.exp(logtput)
            # agg @ Q: the products, then their sum in ascending w
            qvec = sum((agg[:, None] * Q).unbind(0),
                       torch.zeros(W, dtype=dt, device=dev))
            score = cur - qvec[cwl] + crp - (1.0 - cand_tput) * cjr
            masked = torch.where(feas, score, NEG)
            mx = masked.max()
            if not (bool(feas.any()) and bool(mx >= cur - EPS)):
                return used, cur, tie
            at_max = feas & (masked == mx)
            crosstie = int(at_max.sum()) > 1
            if crosstie:
                # current lowest task row per class = numpy's first-max
                # tie-break
                ptr = counts0 - counts + used
                rowkey = rows_pad[arange_c, torch.clamp(ptr, max=M - 1).long()]
                best = int(torch.argmin(torch.where(at_max, rowkey, BIG_I)))
            else:  # the one class at the maximum
                best = int(torch.argmax(at_max.to(torch.uint8)))
            wb = int(cw[best])
            tput_b = cand_tput[best]
            used[best] += 1
            capr = capr - d[best]
            logtput = logtput + logP[cwl, wb]
            agg = agg * P[:, wb]
            agg[wb] = agg[wb] + cjr[best] * tput_b
            cur = mx
            tie = tie or crosstie

    counts, budget = counts0.clone(), budget.clone()
    rec_type = torch.full((max_fills,), -1, dtype=torch.int32, device=dev)
    rec_rep = torch.zeros(max_fills, dtype=torch.int32, device=dev)
    rec_comp = torch.zeros(max_fills, C, dtype=torch.int32, device=dev)
    n_rec, overflow = 0, False
    for t in range(K):
        cost, cap0, rid = costs[t], caps[t], int(rids[t])
        d = cdemand[:, int(fams[t])]  # (C, R) on this family
        go = bool((counts > 0).any())
        while go:
            used, cur, had_tie = fill_one(counts, d, cap0)
            accept = (int(used.sum()) > 0
                      and bool(cur >= cost - EPS - rtol * cost)
                      and int(budget[rid]) > 0)
            rep_c = torch.where(used > 0, counts // torch.clamp(used, min=1),
                                BIG_I)
            rep = 1 if had_tie else min(int(rep_c.min()), int(budget[rid]))
            if accept:
                if n_rec < max_fills:
                    rec_type[n_rec], rec_rep[n_rec] = t, rep
                    rec_comp[n_rec] = used
                else:
                    overflow = True
                n_rec += 1
                counts = counts - rep * used
                budget[rid] -= rep
            go = accept and bool((counts > 0).any())
    return (budget, rec_type, rec_rep, rec_comp,
            torch.tensor(n_rec, dtype=torch.int32, device=dev),
            torch.tensor(overflow, device=dev))
