"""Synergy (OSDI'22) adapted per §6.1: best-fit packing to minimize resource
fragmentation, launching the lowest-cost instance type accommodating a task
when nothing fits, enhanced to be interference-aware via TNRP (online
throughput table, same monitor feed as Eva)."""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.catalog import Catalog
from ..core.cluster_types import ClusterConfig
from ..core.reservation_price import reservation_prices
from ..core.scheduler import SchedulerBase, SchedulerView
from ..core.throughput_table import ThroughputTable
from ..core.workloads import NUM_WORKLOADS
from .common import (cheapest_fitting_type, fits, preserved_assignments,
                     used_capacity)


class SynergyScheduler(SchedulerBase):
    name = "synergy"

    def __init__(self, catalog: Catalog, default_t: float = 0.95):
        super().__init__(catalog)
        self.table = ThroughputTable(NUM_WORKLOADS, default=default_t)

    def observe_single(self, workload, colocated, value):
        self.table.observe_single(workload, colocated, value)

    def observe_job(self, placements, value):
        self.table.observe_job(placements, value)

    def _set_tnrp(self, rows: List[int], view: SchedulerView,
                  rp: np.ndarray) -> float:
        ws = view.tasks.workloads[rows]
        total = 0.0
        for i, r in enumerate(rows):
            others = np.delete(ws, i).tolist()
            total += self.table.lookup(int(ws[i]), others) * rp[r]
        return total

    def schedule(self, view: SchedulerView) -> ClusterConfig:
        rp = reservation_prices(view.tasks, self.catalog)
        assignments = preserved_assignments(view, self.catalog)
        placed = {t for _, tids in assignments for t in tids}
        pending = sorted((t for t in view.tasks.ids.tolist() if t not in placed),
                         key=lambda t: -rp[view.tasks.row(t)])
        used = [used_capacity(tids, view.tasks, self.catalog, k)
                for k, tids in assignments]
        for t in pending:
            row = view.tasks.row(t)
            best, best_left = -1, np.inf
            for i, (k, tids) in enumerate(assignments):
                if not fits(view.tasks, row, self.catalog, k, used[i]):
                    continue
                rows = [view.tasks.row(x) for x in tids] + [row]
                if self._set_tnrp(rows, view, rp) < self.catalog.costs[k] - 1e-9:
                    continue  # would make the instance cost-inefficient
                cap = self.catalog.capacities[k]
                d = view.tasks.demand_by_family[row, self.catalog.family_ids[k], :]
                left = float(((cap - used[i] - d) / np.maximum(cap, 1.0)).sum())
                if left < best_left:
                    best, best_left = i, left
            if best >= 0:
                k = assignments[best][0]
                assignments[best][1].append(t)
                used[best] += view.tasks.demand_by_family[
                    row, self.catalog.family_ids[k], :]
            else:
                k = cheapest_fitting_type(view.tasks, row, self.catalog)
                assignments.append((k, [t]))
                used.append(used_capacity([t], view.tasks, self.catalog, k))
        return ClusterConfig([(k, tuple(tids)) for k, tids in assignments])
