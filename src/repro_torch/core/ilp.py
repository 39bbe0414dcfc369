"""ILP formulation of the provisioning problem (§4.1).

The paper solves this with Gurobi; offline we use scipy's HiGHS MILP.  Same
model (Table 2) plus two standard tightenings that do not change the optimum:

* symmetry breaking — task τ may only be placed on instances i ≤ row(τ)
  (any packing can be relabeled so each instance's index equals its minimum
  task row);
* instead of an explicit zero-cost "ghost" type, Σ_k x_ik ≤ 1 with a linking
  constraint Σ_τ y_iτ ≤ T · Σ_k x_ik.

Per-family demand vectors are handled with per-(instance, type) big-M
capacity constraints.  Also provides a cheap resource-based lower bound used
to report optimality gaps when the solver times out (as Gurobi did for the
paper at 200 tasks / 30 min).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
from scipy.optimize import Bounds, LinearConstraint, milp

from .catalog import Catalog
from .cluster_types import Assignment, ClusterConfig, TaskSet


@dataclasses.dataclass
class ILPResult:
    config: Optional[ClusterConfig]
    cost: float
    lower_bound: float
    status: str


def cost_lower_bound(tasks: TaskSet, catalog: Catalog) -> float:
    """max_r (Σ_τ min-family demand_τ^r) · min_k (C_k / Q_k^r): any valid
    provisioning must pay at least this to cover each resource."""
    best = 0.0
    demand = tasks.demand_by_family.min(axis=1)  # optimistic family
    for r in range(demand.shape[1]):
        total = demand[:, r].sum()
        if total <= 0:
            continue
        have = catalog.capacities[:, r] > 0
        dollars_per_unit = (catalog.costs[have] / catalog.capacities[have, r]).min()
        best = max(best, total * dollars_per_unit)
    return float(best)


def solve_ilp(tasks: TaskSet, catalog: Catalog, *, time_limit_s: float = 60.0,
              mip_rel_gap: float = 0.0) -> ILPResult:
    T = len(tasks)
    K = len(catalog)
    if T == 0:
        return ILPResult(ClusterConfig([]), 0.0, 0.0, "optimal")

    # per-(task, type) demands: (T, K, R)
    D = tasks.demand_by_family[:, catalog.family_ids, :]
    Q = catalog.capacities  # (K, R)
    R = Q.shape[1]

    # variable layout: x[i, k] for i in 0..T-1 -> T*K vars, then
    # y[i, tau] for tau in 0..T-1, i in 0..tau (lower triangular)
    nx = T * K
    y_index = {}
    ny = 0
    for tau in range(T):
        for i in range(tau + 1):
            y_index[(i, tau)] = nx + ny
            ny += 1
    nvar = nx + ny

    def xi(i, k):
        return i * K + k

    c = np.zeros(nvar)
    for i in range(T):
        for k in range(K):
            c[xi(i, k)] = catalog.costs[k]

    rows, cols, vals, lo, hi = [], [], [], [], []
    ncon = 0

    def add_row(entries, lb, ub):
        nonlocal ncon
        for col, v in entries:
            rows.append(ncon)
            cols.append(col)
            vals.append(v)
        lo.append(lb)
        hi.append(ub)
        ncon += 1

    # each task on exactly one instance
    for tau in range(T):
        add_row([(y_index[(i, tau)], 1.0) for i in range(tau + 1)], 1.0, 1.0)
    # each instance has at most one type (none = not provisioned)
    for i in range(T):
        add_row([(xi(i, k), 1.0) for k in range(K)], 0.0, 1.0)
    # linking: tasks only on provisioned instances
    for i in range(T):
        ent = [(y_index[(i, tau)], 1.0) for tau in range(i, T)]
        ent += [(xi(i, k), -float(T)) for k in range(K)]
        add_row(ent, -np.inf, 0.0)
    # capacity with big-M per (i, k, r)
    bigM = D.max(axis=1).sum(axis=0)  # (R,) total worst-case demand
    for i in range(T):
        for k in range(K):
            for r in range(R):
                ent = [(y_index[(i, tau)], float(D[tau, k, r]))
                       for tau in range(i, T) if D[tau, k, r] > 0]
                if not ent:
                    continue
                ent.append((xi(i, k), float(bigM[r])))
                add_row(ent, -np.inf, float(Q[k, r] + bigM[r]))

    A = sp.csc_matrix((vals, (rows, cols)), shape=(ncon, nvar))
    con = LinearConstraint(A, np.array(lo), np.array(hi))
    res = milp(c=c, constraints=con, integrality=np.ones(nvar),
               bounds=Bounds(0, 1),
               options={"time_limit": time_limit_s, "mip_rel_gap": mip_rel_gap})

    lb = cost_lower_bound(tasks, catalog)
    if res.x is None:
        return ILPResult(None, np.inf, lb, res.message)
    x = np.round(res.x).astype(int)
    assignments: List[Assignment] = []
    for i in range(T):
        ks = [k for k in range(K) if x[xi(i, k)]]
        if not ks:
            continue
        tids = tuple(int(tasks.ids[tau]) for tau in range(i, T)
                     if x[y_index[(i, tau)]])
        if tids:
            assignments.append((ks[0], tids))
    cfg = ClusterConfig(assignments)
    lb = max(lb, float(getattr(res, "mip_dual_bound", 0.0) or 0.0))
    status = "optimal" if res.status == 0 else f"status={res.status}"
    return ILPResult(cfg, float(res.fun), lb, status)
