"""Structure-of-arrays fleet state for the vectorized simulator core.

The event-driven simulator keeps rich per-entity objects (``_Instance``,
``_JobState``) for control flow, but its accrual hot path — executed at
every event pop — only needs a handful of numeric columns per entity:
credit balances, net drain rates, job progress rates, service request
rates.  :class:`SlotTable` holds those columns as parallel numpy arrays
over *compact slots* so a billing sweep is a few elementwise array ops
instead of a Python loop over the fleet.

Layout contract
---------------
* Rows live in slots ``[0, n)`` of pre-allocated, capacity-doubling
  arrays; ``table.f[col][:table.n]`` is the live view a sweep operates on.
* ``add``/``remove`` are O(1): removal swaps the last row into the hole
  (swap-remove), so slot order is *not* stable — per-entity access always
  goes through ``slot[entity_id]``, which the swap keeps current.
* Sweeps write columns in place; entity objects that expose one of these
  columns as an attribute read through the table while registered and
  receive the final value back on ``remove`` (the simulator's properties
  handle that hand-off).

Determinism: swap-remove order is a pure function of the event trajectory
(no hashing, no randomness), so vectorized runs are exactly reproducible.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["SlotTable"]

_INITIAL_CAPACITY = 64


class SlotTable:
    """Compact swap-remove table of float64 / bool columns keyed by an
    integer entity id (instance iid or job id).

    Attributes
    ----------
    n : int
        Number of live rows; every column's live data is ``col[:n]``.
    f / b : dict of name -> ndarray
        Float64 and bool column storage (full capacity, not just ``[:n]``).
    slot : dict of entity id -> row index
        Kept current across swap-removes.
    ids : ndarray
        Entity id of each slot (int64), for reverse lookups on swap.
    """

    def __init__(self, float_cols: Sequence[str],
                 bool_cols: Sequence[str] = ()) -> None:
        cap = _INITIAL_CAPACITY
        self.n = 0
        self._cap = cap
        self.ids = np.zeros(cap, dtype=np.int64)
        self.f: Dict[str, np.ndarray] = {
            c: np.zeros(cap, dtype=np.float64) for c in float_cols}
        self.b: Dict[str, np.ndarray] = {
            c: np.zeros(cap, dtype=bool) for c in bool_cols}
        self.slot: Dict[int, int] = {}

    def __len__(self) -> int:
        return self.n

    def __contains__(self, eid: int) -> bool:
        return eid in self.slot

    def _grow(self) -> None:
        new_cap = self._cap * 2
        self.ids = np.resize(self.ids, new_cap)
        for cols in (self.f, self.b):
            for name, arr in cols.items():
                grown = np.zeros(new_cap, dtype=arr.dtype)
                grown[:self._cap] = arr
                cols[name] = grown
        self._cap = new_cap

    def add(self, eid: int, **values) -> int:
        """Register ``eid`` in a fresh slot; unnamed columns start at 0."""
        if eid in self.slot:
            raise ValueError(f"entity {eid} already registered")
        if self.n == self._cap:
            self._grow()
        s = self.n
        self.n += 1
        self.ids[s] = eid
        self.slot[eid] = s
        for name, v in values.items():
            (self.f if name in self.f else self.b)[name][s] = v
        # columns not named in `values` must not inherit a stale row left
        # behind by an earlier swap-remove
        for name, arr in self.f.items():
            if name not in values:
                arr[s] = 0.0
        for name, arr in self.b.items():
            if name not in values:
                arr[s] = False
        return s

    def remove(self, eid: int) -> Dict[str, float]:
        """Drop ``eid``'s row (swap-remove) and return its final column
        values, so the owner can fold them back into the entity object."""
        s = self.slot.pop(eid)
        final = {name: float(arr[s]) for name, arr in self.f.items()}
        final.update({name: bool(arr[s]) for name, arr in self.b.items()})
        last = self.n - 1
        if s != last:
            moved = int(self.ids[last])
            self.ids[s] = moved
            for arr in self.f.values():
                arr[s] = arr[last]
            for arr in self.b.values():
                arr[s] = arr[last]
            self.slot[moved] = s
        self.n = last
        return final

    # -- per-entity scalar access (slow path; sweeps use the arrays) -------
    def get(self, eid: int, col: str):
        s = self.slot[eid]
        if col in self.f:
            return float(self.f[col][s])
        return bool(self.b[col][s])

    def set(self, eid: int, col: str, value) -> None:
        s = self.slot[eid]
        (self.f if col in self.f else self.b)[col][s] = value

    def live(self, col: str) -> np.ndarray:
        """View of the live rows of one column (``col[:n]``)."""
        return (self.f[col] if col in self.f else self.b[col])[:self.n]

    def items(self) -> Tuple[np.ndarray, int]:
        """(ids_view, n) for callers that iterate entities with slots."""
        return self.ids[:self.n], self.n
