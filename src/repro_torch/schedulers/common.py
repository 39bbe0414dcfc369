"""Shared helpers for the baseline schedulers."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.catalog import Catalog, FAMILIES
from ..core.cluster_types import ClusterConfig, TaskSet
from ..core.scheduler import SchedulerView


def demand_on_type(tasks: TaskSet, row: int, catalog: Catalog, k: int) -> np.ndarray:
    return tasks.demand_by_family[row, catalog.family_ids[k], :]


def used_capacity(tids: Sequence[int], tasks: TaskSet, catalog: Catalog,
                  k: int) -> np.ndarray:
    u = np.zeros(catalog.capacities.shape[1])
    for t in tids:
        u += demand_on_type(tasks, tasks.row(t), catalog, k)
    return u


def fits(tasks: TaskSet, row: int, catalog: Catalog, k: int,
         used: np.ndarray) -> bool:
    d = demand_on_type(tasks, row, catalog, k)
    return bool(np.all(used + d <= catalog.capacities[k] + 1e-9))


def cheapest_fitting_type(tasks: TaskSet, row: int, catalog: Catalog) -> int:
    fam = catalog.family_ids
    d = tasks.demand_by_family[row, fam, :]  # (K, R)
    ok = np.all(d <= catalog.capacities + 1e-9, axis=1)
    costs = np.where(ok, catalog.costs, np.inf)
    return int(costs.argmin())


def cheapest_type_for_set(tids: Sequence[int], tasks: TaskSet,
                          catalog: Catalog) -> Optional[int]:
    """Cheapest type fitting all of ``tids`` together (None if impossible)."""
    fam = catalog.family_ids
    d = np.zeros((len(catalog), catalog.capacities.shape[1]))
    for t in tids:
        d += tasks.demand_by_family[tasks.row(t), fam, :]
    ok = np.all(d <= catalog.capacities + 1e-9, axis=1)
    if not ok.any():
        return None
    costs = np.where(ok, catalog.costs, np.inf)
    return int(costs.argmin())


def preserved_assignments(view: SchedulerView, catalog: Optional[Catalog] = None,
                          downsize: bool = True) -> List[Tuple[int, List[int]]]:
    """Existing placements with completed tasks dropped.

    With ``downsize`` (and a catalog), instances whose surviving tenants fit a
    strictly cheaper type are consolidated onto that type — the minimal
    autoscaler policy that keeps migration-averse schedulers from stranding
    long-running tasks on oversized instances after co-tenants depart.
    """
    system = set(view.tasks.ids.tolist())
    out = []
    for inst in view.live:
        alive = [t for t in inst.task_ids if t in system]
        if not alive:
            continue
        k = inst.type_index
        if downsize and catalog is not None:
            k2 = cheapest_type_for_set(alive, view.tasks, catalog)
            if k2 is not None and catalog.costs[k2] < catalog.costs[k] - 1e-9:
                k = k2
        out.append((k, alive))
    return out
