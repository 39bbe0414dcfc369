"""Heterogeneous-resource extension of reservation price (paper §4.2,
"Generalizability to Heterogeneous Resources").

When instance families carry different versions of a resource (A100 vs V100
GPUs; higher-clock C7i CPUs), a task's throughput depends on the family it
lands on.  The paper prescribes: redefine RP as the minimum cost of
executing ONE ITERATION, and evaluate a task-to-instance assignment by
multiplying each task's iteration-RP by its throughput on that instance's
family before comparing against the hourly cost:

    RP_iter(τ) = min_{k feasible} C_k / tput_fam(τ, family(k))
    value of τ on family f = RP_iter(τ) · tput_f(τ)
    assignment cost-efficient  iff  Σ_τ value_f(τ) · tput_coloc(τ,T) ≥ C_k

Implemented as a thin wrapper over the numpy packing engine: the per-type
loop swaps in the family-specific RP vector, so Algorithm 1's structure
(descending-cost types, argmax fills, cost-efficiency gate) is unchanged.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .catalog import Catalog, FAMILIES
from .cluster_types import Assignment, ClusterConfig, TaskSet
from .full_reconfig import EPS, _pack_numpy
from .reservation_price import feasibility_matrix
from .throughput_table import ThroughputTable


def family_tput_matrix(tasks: TaskSet,
                       family_tput: Optional[Dict[int, Dict[str, float]]]
                       ) -> np.ndarray:
    """(T, F) relative standalone throughput of each task per family
    (default 1.0).  family_tput: task_id -> {family_name: tput}."""
    T = len(tasks)
    m = np.ones((T, len(FAMILIES)))
    if family_tput:
        for i, tid in enumerate(tasks.ids.tolist()):
            for fam, v in family_tput.get(tid, {}).items():
                m[i, FAMILIES.index(fam)] = float(v)
    return m


def iteration_rp(tasks: TaskSet, catalog: Catalog,
                 fam_tput: np.ndarray) -> np.ndarray:
    """(T,) RP_iter: minimum hourly cost per unit of standalone work."""
    feas = feasibility_matrix(tasks, catalog)  # (T, K)
    tput_k = fam_tput[:, catalog.family_ids]  # (T, K)
    cost_per_work = np.where(feas & (tput_k > 0),
                             catalog.costs[None, :] / np.maximum(tput_k, 1e-9),
                             np.inf)
    rp = cost_per_work.min(axis=1)
    if np.any(~np.isfinite(rp)):
        bad = tasks.ids[~np.isfinite(rp)]
        raise ValueError(f"tasks {bad.tolist()} fit no instance type")
    return rp


def full_reconfiguration_hetero(
        tasks: TaskSet, catalog: Catalog,
        table: Optional[ThroughputTable] = None, *,
        family_tput: Optional[Dict[int, Dict[str, float]]] = None,
        interference_aware: bool = True) -> ClusterConfig:
    """Algorithm 1 with per-family throughput-scaled reservation prices."""
    if len(tasks) == 0:
        return ClusterConfig([])
    fam_tput = family_tput_matrix(tasks, family_tput)
    rp_iter = iteration_rp(tasks, catalog, fam_tput)
    if interference_aware and table is not None:
        pairwise = table.pairwise_matrix()
    else:
        n = int(tasks.workloads.max()) + 1
        pairwise = np.ones((n, n))

    # per-type packing with the family-specific value vector; mirrors the
    # descending-cost outer loop of Algorithm 1 by restricting the catalog
    # to one type per call and keeping a shared unassigned pool.
    assignments: List[Assignment] = []
    remaining = tasks
    id_rows = {int(t): i for i, t in enumerate(tasks.ids.tolist())}
    unassigned = set(tasks.ids.tolist())
    for k in catalog.order_desc.tolist():
        if not unassigned:
            break
        sub_ids = sorted(unassigned)
        sub = tasks.subset(sub_ids)
        rows = np.array([id_rows[t] for t in sub_ids])
        fam = catalog.family_ids[k]
        rp_fam = rp_iter[rows] * fam_tput[rows, fam]
        one_type = Catalog.from_types([catalog.types[k]])
        packed = _pack_numpy(sub.demand_by_family, sub.workloads, rp_fam,
                             rp_fam, one_type, pairwise)
        for _, prows in packed:
            tids = tuple(int(sub.ids[r]) for r in prows)
            assignments.append((k, tids))
            unassigned -= set(tids)
    return ClusterConfig(assignments)
