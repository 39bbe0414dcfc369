"""Stratus (SoCC'18) adapted per §6.1: runtime-binned packing, migration-
averse.  Tasks are co-located only with tasks of a similar remaining-runtime
class (log2 bins), so instances drain together and are released promptly.
Per the paper's best-case comparison, Stratus receives oracle runtime
estimates (total iterations / standalone throughput)."""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from ..core.catalog import Catalog
from ..core.cluster_types import ClusterConfig
from ..core.scheduler import SchedulerBase, SchedulerView
from .common import (cheapest_fitting_type, fits, preserved_assignments,
                     used_capacity)


def _bin(remaining_s: float) -> int:
    return max(0, math.ceil(math.log2(max(remaining_s, 1.0) / 60.0)))


class StratusScheduler(SchedulerBase):
    name = "stratus"
    needs_runtime_estimates = True

    def schedule(self, view: SchedulerView) -> ClusterConfig:
        rem = view.remaining_s or {}
        assignments = preserved_assignments(view, self.catalog)
        placed = {t for _, tids in assignments for t in tids}
        pending = sorted((t for t in view.tasks.ids.tolist() if t not in placed),
                         key=lambda t: -rem.get(t, 0.0))
        # per-assignment spare capacity + runtime bin (max remaining on board)
        used = [used_capacity(tids, view.tasks, self.catalog, k)
                for k, tids in assignments]
        bins = [max((_bin(rem.get(t, 0.0)) for t in tids), default=0)
                for _, tids in assignments]
        for t in pending:
            row = view.tasks.row(t)
            b = _bin(rem.get(t, 0.0))
            best, best_left = -1, np.inf
            for i, (k, tids) in enumerate(assignments):
                if bins[i] != b:
                    continue
                if not fits(view.tasks, row, self.catalog, k, used[i]):
                    continue
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
                bins[best] = max(bins[best], b)
            else:
                k = cheapest_fitting_type(view.tasks, row, self.catalog)
                assignments.append((k, [t]))
                used.append(used_capacity([t], view.tasks, self.catalog, k))
                bins.append(b)
        return ClusterConfig([(k, tuple(tids)) for k, tids in assignments])
