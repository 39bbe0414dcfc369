"""Full Reconfiguration (paper Algorithm 1) and configuration evaluation.

Two equivalent engines are provided:

* ``engine="python"`` — a literal transcription of the paper's pseudocode
  (argmax over unassigned tasks of TNRP(T ∪ {τ}), O(|T|²) evaluations).
* ``engine="numpy"``  — vectorized candidate evaluation: adding τ to a set T
  multiplies every member's predicted throughput by P[w_m, w_τ] and gives τ
  the product Π_m P[w_τ, w_m]; TNRP sums for all candidates are computed in
  one shot.  Identical tie-breaking (first maximal row index).
* ``engine="jax"``    — jitted lax.while_loop engine (see engine_jax.py).

Predicted throughput during packing uses the pairwise-product estimator over
the online co-location table snapshot (§4.3); evaluation of *live* instances
(`evaluate_assignments`) uses exact-or-pairwise table lookups.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .catalog import Catalog
from .cluster_types import Assignment, ClusterConfig, TaskSet
from .reservation_price import job_rp_sums, reservation_prices
from .throughput_table import ThroughputTable

EPS = 1e-9


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------
def _tnrp_terms(rp: np.ndarray, tput: np.ndarray, job_rp: Optional[np.ndarray]):
    """Per-task TNRP values given throughputs (vectorized, any shape)."""
    if job_rp is None:
        return tput * rp
    return rp - (1.0 - tput) * job_rp


def predicted_set_tnrp(rows: Sequence[int], workloads: np.ndarray,
                       pairwise: np.ndarray, rp: np.ndarray,
                       job_rp: Optional[np.ndarray]) -> float:
    """TNRP(T) for a hypothetical co-located set, pairwise-product predictor."""
    rows = list(rows)
    if not rows:
        return 0.0
    w = workloads[rows]
    P = pairwise[np.ix_(w, w)]
    np.fill_diagonal(P, 1.0)
    tputs = P.prod(axis=1)
    jr = job_rp[rows] if job_rp is not None else None
    return float(_tnrp_terms(rp[rows], tputs, jr).sum())


# --------------------------------------------------------------------------
# paper-faithful engine (Algorithm 1 verbatim)
# --------------------------------------------------------------------------
def _pack_python(demand: np.ndarray, workloads: np.ndarray, rp: np.ndarray,
                 job_rp: Optional[np.ndarray], catalog: Catalog,
                 pairwise: np.ndarray,
                 type_mask: Optional[np.ndarray] = None,
                 region_budget: Optional[np.ndarray] = None
                 ) -> List[Tuple[int, List[int]]]:
    T = demand.shape[0]
    unassigned = set(range(T))
    out: List[Tuple[int, List[int]]] = []
    for k in catalog.order_desc.tolist():  # descending cost (Line 2)
        if type_mask is not None and not type_mask[k]:
            continue  # type unavailable (region restriction)
        rid = catalog.region_of(k) if region_budget is not None else None
        fam = catalog.family_ids[k]
        d = demand[:, fam, :]
        cost = catalog.costs[k]
        while True:  # Line 4: keep provisioning this type
            if rid is not None and region_budget[rid] <= 0:
                break  # region at its instance-count cap
            cap = catalog.capacities[k].copy()
            members: List[int] = []
            cur = 0.0
            while True:  # Lines 7-13: fill the instance
                best_row, best_val = -1, -np.inf
                for r in sorted(unassigned):
                    if r in members or np.any(d[r] > cap + EPS):
                        continue
                    v = predicted_set_tnrp(members + [r], workloads, pairwise,
                                           rp, job_rp)
                    if v > best_val + EPS:
                        best_row, best_val = r, v
                if best_row < 0:
                    break  # nothing fits
                if best_val < cur - EPS:
                    break  # Line 9-11: adding decreases TNRP
                members.append(best_row)
                cap = cap - d[best_row]
                cur = best_val
            if members and cur >= cost - EPS:  # Line 14: cost-efficient
                out.append((k, members))
                unassigned -= set(members)
                if rid is not None:
                    region_budget[rid] -= 1
            else:
                break  # Line 17: move to a cheaper type
    return out


# --------------------------------------------------------------------------
# vectorized engine
# --------------------------------------------------------------------------
def _pack_numpy(demand: np.ndarray, workloads: np.ndarray, rp: np.ndarray,
                job_rp: Optional[np.ndarray], catalog: Catalog,
                pairwise: np.ndarray,
                type_mask: Optional[np.ndarray] = None,
                region_budget: Optional[np.ndarray] = None
                ) -> List[Tuple[int, List[int]]]:
    T = demand.shape[0]
    unassigned = np.ones(T, dtype=bool)
    out: List[Tuple[int, List[int]]] = []
    has_jr = job_rp is not None
    for k in catalog.order_desc.tolist():
        if type_mask is not None and not type_mask[k]:
            continue  # type unavailable (region restriction)
        rid = catalog.region_of(k) if region_budget is not None else None
        fam = catalog.family_ids[k]
        d = demand[:, fam, :]  # (T, R)
        cost = catalog.costs[k]
        cap_full = catalog.capacities[k]
        while unassigned.any():
            if rid is not None and region_budget[rid] <= 0:
                break  # region at its instance-count cap
            cap = cap_full.copy()
            members: List[int] = []
            m_w = np.zeros(0, dtype=np.int64)  # member workloads
            m_tput = np.zeros(0)  # member predicted throughputs
            avail = unassigned.copy()
            cur = 0.0
            while True:
                feas = avail & np.all(d <= cap[None, :] + EPS, axis=1)
                cand = np.nonzero(feas)[0]
                if cand.size == 0:
                    break
                wc = workloads[cand]
                if members:
                    fm = pairwise[np.ix_(m_w, wc)]  # (|T|, C) member degradation
                    new_m_tput = m_tput[:, None] * fm
                    cand_tput = pairwise[wc[:, None], m_w[None, :]].prod(axis=1)
                else:
                    new_m_tput = np.zeros((0, cand.size))
                    cand_tput = np.ones(cand.size)
                if has_jr:
                    m_terms = (rp[members, None]
                               - (1.0 - new_m_tput) * job_rp[members, None]).sum(0)
                    c_terms = rp[cand] - (1.0 - cand_tput) * job_rp[cand]
                else:
                    m_terms = (rp[members, None] * new_m_tput).sum(0)
                    c_terms = rp[cand] * cand_tput
                tot = m_terms + c_terms
                b = int(np.argmax(tot))  # first max == python engine tie-break
                if tot[b] < cur - EPS:
                    break
                r = int(cand[b])
                members.append(r)
                if m_tput.size:
                    m_tput = m_tput * fm[:, b]
                m_tput = np.concatenate([m_tput, [cand_tput[b]]])
                m_w = np.concatenate([m_w, [wc[b]]])
                cap = cap - d[r]
                avail[r] = False
                cur = float(tot[b])
            if members and cur >= cost - EPS:
                out.append((k, members))
                unassigned[members] = False
                if rid is not None:
                    region_budget[rid] -= 1
            else:
                break
    return out


# --------------------------------------------------------------------------
# public API
# --------------------------------------------------------------------------
def full_reconfiguration(tasks: TaskSet, catalog: Catalog,
                         table: Optional[ThroughputTable] = None, *,
                         interference_aware: bool = True,
                         multi_task_aware: bool = True,
                         engine: str = "numpy",
                         rp: Optional[np.ndarray] = None,
                         job_rp: Optional[np.ndarray] = None,
                         time_s: Optional[float] = None,
                         type_mask: Optional[np.ndarray] = None,
                         region_caps: Optional[Sequence[Optional[int]]] = None,
                         credit_horizon_s: Optional[float] = None
                         ) -> ClusterConfig:
    """Run Algorithm 1 over ``tasks`` and return the packed configuration.

    ``rp``/``job_rp`` may be precomputed (partial reconfiguration passes the
    system-wide job RP sums so multi-task penalties count non-migrating
    siblings too).  ``time_s`` snapshots a spot catalog at the given instant
    so packing order and reservation prices follow current prices.
    ``type_mask`` ((K,) bool) excludes types from both reservation prices and
    provisioning — used to restrict packing to one region of a multi-region
    catalog.  ``region_caps`` (one optional int per region) bounds how many
    instances the pack may emit per region: once a region's budget is spent,
    provisioning overflows to the next type in descending-cost order, so
    capped-but-cheap regions fill to their cap instead of starving the
    overflow.  On a region-expanded catalog without mask or caps, Algorithm 1
    prices candidate instances across every region (region-qualified types
    are ordinary types to it).  ``credit_horizon_s`` packs against the
    credit-priced planning snapshot (``catalog.credit_priced``): burstable
    types whose launch credits will not last the horizon look
    proportionally dearer, so both the descending-cost order and the
    cost-efficiency bar see effective $/throughput instead of the sticker
    price (identity for non-burstable catalogs).
    """
    if time_s is not None:
        catalog = catalog.at(time_s)
    if credit_horizon_s is not None:
        catalog = catalog.credit_priced(credit_horizon_s)
    if len(tasks) == 0:
        return ClusterConfig([])
    region_budget = None
    if region_caps is not None and catalog.region_ids is not None \
            and any(c is not None for c in region_caps):
        big = np.iinfo(np.int64).max
        region_budget = np.array([big if c is None else int(c)
                                  for c in region_caps], dtype=np.int64)
    if rp is None:
        rp = reservation_prices(tasks, catalog, type_mask=type_mask)
    if multi_task_aware and job_rp is None:
        job_rp = job_rp_sums(tasks, rp)
    if not multi_task_aware:
        job_rp = None
    if interference_aware and table is not None:
        pairwise = table.pairwise_matrix()
    else:
        n = int(tasks.workloads.max()) + 1 if len(tasks) else 1
        pairwise = np.ones((max(n, 1), max(n, 1)))
    if engine == "jax":
        raise ValueError("engine='jax': the port packs with engine='torch' "
                         "(on the card) or engine='torch:cpu'")
    elif engine in ("torch", "torch:cpu"):
        from .engine_torch import pack_torch
        device = "cpu" if engine == "torch:cpu" else "cuda"

        def packer(*args):
            return pack_torch(*args, device=device)
    else:
        packer = {"python": _pack_python, "numpy": _pack_numpy}[engine]
    packed = packer(tasks.demand_by_family, tasks.workloads, rp,
                    job_rp, catalog, pairwise, type_mask, region_budget)
    assignments: List[Assignment] = [
        (k, tuple(int(tasks.ids[r]) for r in rows)) for k, rows in packed
    ]
    if region_budget is not None:
        # Overflow re-pack: RP is the *global* cheapest price, so once a
        # cheap region's budget is spent, dearer regions' types can never
        # look cost-efficient against it and the overflow would starve.
        # Re-anchor reservation prices to the still-available types and pack
        # the remainder (repeat until everyone is placed or nothing is
        # available — truly full markets leave tasks pending for the
        # simulator/next round to retry).
        sub_packer = packer
        placed = {t for _, ts in assignments for t in ts}
        left = [int(t) for t in tasks.ids.tolist() if t not in placed]
        while left:
            avail = region_budget[catalog.region_ids] > 0
            if type_mask is not None:
                avail = avail & np.asarray(type_mask)
            if not avail.any():
                break
            sub = tasks.subset(left)
            try:
                rp_sub = reservation_prices(sub, catalog, type_mask=avail)
            except ValueError:
                break  # remainder fits no available type
            # multi-task penalties keep the *system-wide* job RP sums (already
            # placed siblings still count), same as partial_reconfiguration
            jr_sub = None
            if job_rp is not None:
                jr_sub = job_rp[np.array([tasks.row(t) for t in left])]
            sub_packed = sub_packer(sub.demand_by_family, sub.workloads,
                                    rp_sub, jr_sub, catalog, pairwise,
                                    avail, region_budget)
            if not sub_packed:
                break
            assignments += [(k, tuple(int(sub.ids[r]) for r in rows))
                            for k, rows in sub_packed]
            placed = {t for _, ts in assignments for t in ts}
            left = [t for t in left if t not in placed]
    return ClusterConfig(assignments)


def evaluate_assignments(assignments: Sequence[Assignment], tasks: TaskSet,
                         catalog: Catalog, table: Optional[ThroughputTable],
                         multi_task_aware: bool = True,
                         type_mask: Optional[np.ndarray] = None):
    """Per-instance (TNRP(T_i), C_i) for *live* placements, using
    exact-or-pairwise table lookups of the actual co-location sets."""
    rp = reservation_prices(tasks, catalog, type_mask=type_mask)
    job_rp = job_rp_sums(tasks, rp) if multi_task_aware else None
    tnrps, costs = [], []
    for k, tids in assignments:
        rows = [tasks.row(t) for t in tids]
        ws = tasks.workloads[rows]
        total = 0.0
        for i, r in enumerate(rows):
            others = np.delete(ws, i)
            tput = table.lookup(int(ws[i]), others.tolist()) if table else 1.0
            jr = job_rp[r] if job_rp is not None else None
            total += float(_tnrp_terms(rp[r], np.asarray(tput), jr))
        tnrps.append(total)
        costs.append(float(catalog.costs[k]))
    return np.array(tnrps), np.array(costs)
