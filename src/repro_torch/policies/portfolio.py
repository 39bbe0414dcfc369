"""Commitment-portfolio layer: sunk-cost planning over reserved pools plus
a periodic commitment-inventory pass (Voorsluys et al., 1110.5972).

Reserved/committed capacity inverts the per-round economics Algorithm 1
prices: a commitment pool bills its discounted rate for every slot every
hour *whether used or idle*, so the **marginal** price of placing work on
a pool slot is ≈ 0 while an empty slot is pure waste.  ``PortfolioLayer``
expresses that inversion purely on the PR 5 hooks — the scheduler itself
stays Algorithm 1 + the ensemble criterion:

* ``plan_catalog`` (PLANNING phase) re-prices pool types at
  ``sunk_fraction`` × their committed rate (0 by default: sunk cost), so
  reservation prices and Algorithm 1's descending-cost order fill the
  commitments first and overflow lands on the market types at their
  spot/on-demand prices.  Billing always uses the raw catalog — the
  simulator's standing pool bill is what actually pays for the slots.
* ``region_caps`` bounds each pool at its size (``max_instances`` on the
  pool region), so the planner never over-fills a commitment; the
  simulator's launch denial is the hard backstop.
* ``keep_bonus`` grants pool residents slack equal to the committed rate:
  evicting them saves nothing (the slot bills regardless), so the
  S·D̂ > ΔM test never churns committed residents for a market price dip.
* a periodic **inventory pass** (``pre_round``) re-sizes commitments from
  the observed steady-state base: it tracks the occupied same-hardware
  fleet per pool, takes the windowed *minimum* as the committed-capacity
  candidate (the base that persisted, not the burst), and grows the pool
  — monotonically; commitments cannot be un-bought — when the
  ``PriceForecaster`` horizon estimate of the market price exceeds the
  committed rate.  Orders flow to the simulator through the scheduler's
  ``commitment_orders`` attribute and to the planner by replacing
  ``stack.caps`` (read every round).
* cross-provider arbitrage needs no code here: it rides the existing
  per-region-pair repack (``MultiRegionLayer.refine``) — the
  provider-aware ``TransferMatrix`` already prices inter-provider egress
  into S·D̂ > ΔM through ``task_move_cost`` / ``migration_cost``.

The layer is hook-for-hook the identity on catalogs without commitment
pools (including any single- or multi-region catalog and commitment-free
``multi_provider_catalog``s), pinned by the bit-identity tests in
``tests/test_policies.py``.
"""
from __future__ import annotations

from typing import Dict, List, Set, Tuple

import dataclasses

import numpy as np

from .base import PLANNING, PolicyLayer


class PortfolioLayer(PolicyLayer):
    """Commitment-portfolio awareness over ``multi_provider_catalog``s.

    Knobs
    -----
    sunk_fraction     : planning price of a pool type as a fraction of its
                        committed rate (0 = pure sunk cost; 1 disables the
                        fill-first repricing)
    resize            : enable the periodic commitment-inventory pass
    resize_interval_s : how often the inventory pass may re-size pools
    window            : demand samples (rounds) the steady-base minimum is
                        taken over — the base must persist a full window
                        before the layer commits to it
    forecast_horizon_s: floor on the market-price forecast horizon the
                        buy-more test compares the committed rate against
                        (the effective horizon is ``max(horizon, D̂)``)
    """

    name = "portfolio"
    catalog_phase = PLANNING

    def __init__(self, *, sunk_fraction: float = 0.0, resize: bool = True,
                 resize_interval_s: float = 3600.0, window: int = 6,
                 forecast_horizon_s: float = 4 * 3600.0):
        assert 0.0 <= sunk_fraction <= 1.0
        self.sunk_fraction = float(sunk_fraction)
        self.resize = bool(resize)
        self.resize_interval_s = float(resize_interval_s)
        self.window = int(window)
        self.forecast_horizon_s = float(forecast_horizon_s)
        # pool-region-name -> target size; the simulator polls this via the
        # scheduler's commitment_orders property and applies it
        # monotonically, so the dict holds current targets, not deltas
        self.commitment_orders: Dict[str, int] = {}
        self.resizes_ordered = 0
        self._pools: List[Tuple[int, int, int, int, str]] = []
        self._last_inventory: float = -1.0

    # -- binding -------------------------------------------------------------
    def bind(self, scheduler) -> None:
        super().bind(scheduler)
        cat = scheduler.catalog
        self._pools = []
        self._pool_mask = None
        if cat.regions is None:
            return
        for ri, cm in cat.commitment_pools():
            ks = np.nonzero(cat.region_ids == ri)[0]
            k = int(ks[0])
            b = int(cat.base_index[k])
            prov = cat.regions[ri].provider
            # the market copy of the committed hardware in the same
            # provider: the overflow price the buy-more test compares to
            k_mkt = k
            for k2 in np.nonzero(cat.base_index == b)[0].tolist():
                r2 = int(cat.region_ids[k2])
                if (cat.regions[r2].commitment is None
                        and cat.regions[r2].provider == prov):
                    k_mkt = int(k2)
                    break
            self._pools.append((ri, k, b, k_mkt, cat.regions[ri].name))
        if self._pools:
            self._pool_mask = cat.commitment_type_mask()
            self._sizes = {ri: int(cat.regions[ri].commitment.pool_size)
                           for ri, *_ in self._pools}
            self._samples = {ri: [] for ri, *_ in self._pools}

    def post_bind(self, stack) -> None:
        self._stack = stack

    # -- planning: commitments fill first ------------------------------------
    def plan_catalog(self, catalog, view, d_hat_s):
        """Pool slots are already paid for: present them at marginal price
        ``sunk_fraction`` × rate (≈ 0) so Algorithm 1 fills them first,
        bounded by the pool caps.  Identity without pools."""
        if not self._pools or self.sunk_fraction == 1.0:
            return catalog
        costs = catalog.costs * np.where(self._pool_mask,
                                         self.sunk_fraction, 1.0)
        order = np.argsort(-costs, kind="stable")
        return dataclasses.replace(catalog, costs=costs, order_desc=order)

    # -- keep test: committed residents are free to keep ---------------------
    def keep_bonus(self, raw, cat, view):
        """Evicting a pool resident saves nothing — the slot's standing
        bill continues either way — so grant exactly the committed rate
        as keep slack against the S·D̂ > ΔM test."""
        if not self._pools:
            return None
        mask = self._pool_mask
        costs = raw.costs

        def pool_bonus(k: int, tids) -> float:
            return float(costs[k]) if mask[k] else 0.0

        return pool_bonus

    # -- packing budgets -----------------------------------------------------
    def region_caps(self, catalog):
        """Pool sizes bound the planner (same values MultiRegionLayer
        derives; first non-None wins, so stacking both is harmless)."""
        if not self._pools:
            return None
        return tuple(r.max_instances for r in catalog.regions)

    # -- inventory pass ------------------------------------------------------
    def pre_round(self, view, d_hat_s) -> Tuple[object, Set[int]]:
        if not self._pools or not self.resize:
            return view, set()
        cat = self.sched.catalog
        for ri, k, b, _k_mkt, _name in self._pools:
            prov = cat.regions[ri].provider
            n = 0
            for inst in view.live:
                ki = inst.type_index
                if (int(cat.base_index[ki]) == b and inst.task_ids
                        and cat.provider_of(ki) == prov):
                    n += 1
            s = self._samples[ri]
            s.append(n)
            del s[:-self.window]
        if self._last_inventory < 0.0:
            self._last_inventory = view.time
        elif view.time - self._last_inventory >= self.resize_interval_s:
            self._inventory(view.time, d_hat_s)
            self._last_inventory = view.time
        return view, set()

    def _inventory(self, now_s: float, d_hat_s: float) -> None:
        """Grow each pool to the windowed steady-base minimum when the
        forecast market price of the same hardware exceeds the committed
        rate.  Monotonic: a commitment, once bought, stays bought."""
        # deferred import: repro.autoscale itself imports core submodules
        from ..autoscale.forecast import PriceForecaster
        cat = self.sched.catalog
        fc = PriceForecaster.for_catalog(cat)
        horizon = max(self.forecast_horizon_s, d_hat_s)
        mult = fc.mean_multipliers(len(cat), now_s, horizon)
        for ri, k, _b, k_mkt, name in self._pools:
            samples = self._samples[ri]
            if len(samples) < self.window:
                continue  # the base has not persisted a full window yet
            steady = min(samples)
            if steady <= self._sizes[ri]:
                continue
            rate = float(cat.costs[k])  # committed $/h (static)
            forecast_market = float(cat.costs[k_mkt] * mult[k_mkt])
            if rate >= forecast_market:
                continue  # the market is forecast cheaper: stay on spot
            self._sizes[ri] = int(steady)
            self.commitment_orders[name] = int(steady)
            self.resizes_ordered += 1
            if self._stack.caps is not None:
                caps = list(self._stack.caps)
                caps[ri] = int(steady)
                self._stack.caps = tuple(caps)

    # -- observability -------------------------------------------------------
    def summary(self) -> dict:
        if not self._pools:
            return {}
        return {"commitment_resizes_ordered": self.resizes_ordered}
