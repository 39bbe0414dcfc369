"""Co-location throughput table (§4.3) + multi-task attribution rules (§4.4).

Entries are keyed by (workload, sorted-tuple-of-co-located-workloads).  A
lookup returns the exact entry when the set has been observed, otherwise the
product of pairwise entries; unseen pairwise entries default to ``t``
(0.95 in all paper experiments).

For multi-task (data-parallel) jobs, a single observed job throughput must be
attributed to ONE straggler entry; the three rules from §4.4 keep recorded
values lower bounds of the true co-location throughput, adjusted upwards as
more observations arrive.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

Key = Tuple[int, Tuple[int, ...]]


def _key(w: int, colocated: Sequence[int]) -> Key:
    return (int(w), tuple(sorted(int(x) for x in colocated)))


class ThroughputTable:
    def __init__(self, num_workloads: int, default: float = 0.95):
        self.num_workloads = int(num_workloads)
        self.default = float(default)
        self.entries: Dict[Key, float] = {}

    # ------------------------------------------------------------------ read
    def pairwise(self, w1: int, w2: int) -> float:
        return self.entries.get(_key(w1, (w2,)), self.default)

    def pairwise_matrix(self) -> np.ndarray:
        """(W, W) snapshot of current pairwise estimates (default-filled).
        Used by the packing engines for vectorized TNRP prediction."""
        n = self.num_workloads
        m = np.full((n, n), self.default)
        for (w, co), v in self.entries.items():
            if len(co) == 1:
                m[w, co[0]] = v
        return m

    def lookup(self, w: int, colocated: Sequence[int]) -> float:
        """Exact entry if the co-location set was observed, else the product
        of pairwise estimates (§4.3)."""
        co = tuple(sorted(int(x) for x in colocated))
        if not co:
            return 1.0
        exact = self.entries.get((int(w), co))
        if exact is not None:
            return exact
        t = 1.0
        for w2 in co:
            t *= self.pairwise(w, w2)
        return t

    def recorded(self, w: int, colocated: Sequence[int]):
        return self.entries.get(_key(w, colocated))

    # ----------------------------------------------------------------- write
    def record(self, w: int, colocated: Sequence[int], value: float) -> None:
        if not colocated:  # solo tasks have tput 1 by definition
            return
        self.entries[_key(w, colocated)] = float(value)

    def observe_single(self, w: int, colocated: Sequence[int], value: float) -> None:
        """Single-task job: degradation is attributable directly (§4.4)."""
        self.record(w, colocated, value)

    def observe_job(self, placements: List[Tuple[int, Tuple[int, ...]]],
                    value: float) -> None:
        """Multi-task job observation.

        placements: per task, (workload, tuple of co-located workloads).
        value: observed normalized job throughput (shared by all tasks of a
        data-parallel job).  Applies the three attribution rules of §4.4 and
        updates exactly one entry.
        """
        # Solo tasks (empty co-location set) have tput 1 by definition and
        # cannot be the straggler entry.
        cands = [(w, co) for (w, co) in placements if co]
        if not cands:
            return
        recs = [(w, co, self.recorded(w, co)) for (w, co) in cands]
        unrecorded = [(w, co) for (w, co, r) in recs if r is None]
        recorded = [(w, co, r) for (w, co, r) in recs if r is not None]

        if not recorded:
            # Rule 1: no previous observations -> update the task co-located
            # with the most tasks.
            w, co = max(unrecorded, key=lambda x: len(x[1]))
            self.record(w, co, value)
            return
        lower = [(w, co, r) for (w, co, r) in recorded if r < value]
        if lower:
            # Rule 2: some recorded throughput is lower than observed ->
            # update (raise) the entry with the lowest recorded throughput.
            w, co, _ = min(lower, key=lambda x: x[2])
            self.record(w, co, value)
            return
        if unrecorded:
            # Rule 3: all recorded are higher -> the straggler must be an
            # unrecorded task; update the one co-located with the most tasks.
            w, co = max(unrecorded, key=lambda x: len(x[1]))
            self.record(w, co, value)
            return
        # Edge case (not covered by the paper's rules): everything recorded
        # and all recorded values exceed the observation.  Preserve the
        # lower-bound invariant by lowering the minimum entry.
        w, co, _ = min(recorded, key=lambda x: x[2])
        self.record(w, co, value)

    # ------------------------------------------------------------------ misc
    def __len__(self) -> int:
        return len(self.entries)
