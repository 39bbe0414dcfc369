"""Owl (SoCC'22) adapted per §6.1: interference-minimizing pair co-location.

Owl profiles all pairwise co-location throughputs in advance; the paper
provides this profile exclusively to Owl, so the simulator's ground-truth
matrix is injected at construction.  Pairs are considered in descending
ratio of pair TNRP to the cost of the cheapest instance type accommodating
both, and only low-interference pairs (min pairwise throughput ≥ threshold)
are co-located; everything else runs solo.  No migrations."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.catalog import Catalog
from ..core.cluster_types import ClusterConfig
from ..core.reservation_price import reservation_prices
from ..core.scheduler import SchedulerBase, SchedulerView
from .common import cheapest_fitting_type, preserved_assignments


class OwlScheduler(SchedulerBase):
    name = "owl"
    needs_true_profile = True

    def __init__(self, catalog: Catalog, profile: np.ndarray,
                 min_pair_tput: float = 0.9):
        super().__init__(catalog)
        self.profile = profile
        self.min_pair_tput = min_pair_tput

    def _pair_type(self, r1: int, r2: int, view: SchedulerView) -> Optional[int]:
        fam = self.catalog.family_ids
        d = (view.tasks.demand_by_family[r1, fam, :]
             + view.tasks.demand_by_family[r2, fam, :])
        ok = np.all(d <= self.catalog.capacities + 1e-9, axis=1)
        if not ok.any():
            return None
        costs = np.where(ok, self.catalog.costs, np.inf)
        return int(costs.argmin())

    def schedule(self, view: SchedulerView) -> ClusterConfig:
        rp = reservation_prices(view.tasks, self.catalog)
        assignments = preserved_assignments(view, self.catalog)
        placed = {t for _, tids in assignments for t in tids}
        pending = [t for t in view.tasks.ids.tolist() if t not in placed]

        # candidate pairs: pending×pending (fresh right-sized instance) and
        # pending×running-solo (join the solo task's existing instance if the
        # pair fits it) — Owl continuously fills servers with low-
        # interference pairs; no migrations.
        solos = [(i, k, tids[0]) for i, (k, tids) in enumerate(assignments)
                 if len(tids) == 1]
        cands = []
        for a in range(len(pending)):
            r1 = view.tasks.row(pending[a])
            w1 = view.tasks.workloads[r1]
            for b in range(a + 1, len(pending)):
                r2 = view.tasks.row(pending[b])
                w2 = view.tasks.workloads[r2]
                t12, t21 = self.profile[w1, w2], self.profile[w2, w1]
                if min(t12, t21) < self.min_pair_tput:
                    continue
                k = self._pair_type(r1, r2, view)
                if k is None:
                    continue
                pair_tnrp = t12 * rp[r1] + t21 * rp[r2]
                if pair_tnrp < self.catalog.costs[k] - 1e-9:
                    continue
                cands.append((pair_tnrp / self.catalog.costs[k],
                              pending[a], pending[b], k, None))
            for slot, k, other in solos:
                r2 = view.tasks.row(other)
                w2 = view.tasks.workloads[r2]
                t12, t21 = self.profile[w1, w2], self.profile[w2, w1]
                if min(t12, t21) < self.min_pair_tput:
                    continue
                fam = self.catalog.family_ids[k]
                d = (view.tasks.demand_by_family[r1, fam, :]
                     + view.tasks.demand_by_family[r2, fam, :])
                if not np.all(d <= self.catalog.capacities[k] + 1e-9):
                    continue
                pair_tnrp = t12 * rp[r1] + t21 * rp[r2]
                if pair_tnrp < self.catalog.costs[k] - 1e-9:
                    continue
                cands.append((pair_tnrp / self.catalog.costs[k],
                              pending[a], other, k, slot))
        cands.sort(key=lambda x: -x[0])
        taken, used_slots = set(), set()
        for _, t1, t2, k, slot in cands:
            if t1 in taken or t2 in taken or (slot is not None and slot in used_slots):
                continue
            if slot is None:
                assignments.append((k, [t1, t2]))
            else:
                assignments[slot][1].append(t1)
                used_slots.add(slot)
            taken |= {t1, t2}
        for t in pending:
            if t in taken:
                continue
            k = cheapest_fitting_type(view.tasks, view.tasks.row(t), self.catalog)
            assignments.append((k, [t]))
        return ClusterConfig([(k, tuple(tids)) for k, tids in assignments])
