"""Horizon price forecasts from any ``core.catalog.PriceModel``.

``PriceForecaster`` answers the planning question admission control needs:
*what will this market cost, on average, over the next H seconds* — and
*what does it cost in the long run* (the anchor a strike price is derived
from).  One forecaster per price-model kind, mirroring the ``PriceModel``
hierarchy (Gao 2020's predictive-autoscaler horizon forecasts are the
reference design):

* ``PriceForecaster`` (static passthrough) — prices never move, so the
  forecast is *exact*: forecast == anchor == base costs.
* ``OUForecaster`` — closed-form mean reversion of the discrete OU
  log-price process the ``MeanRevertingPriceModel`` samples:
  ``E[x_k] = mu + (x_0 - mu)(1 - r)^k``; the horizon forecast averages the
  median path ``exp(E[x_k])`` over the horizon steps (clipped to the
  model's own price band) and converges to the stationary mean
  (``discount`` x on-demand) as the horizon grows.
* ``TraceForecaster`` — *lookahead-free* empirical forecast for replayed
  traces: only breakpoints at times <= now are consulted (the future of
  the trace is exactly what a deployed forecaster would not have).  The
  current multiplier is assumed to persist for the median observed
  holding time, then revert to an empirical quantile (default the median)
  of the history.
* ``RegionForecaster`` — block-composition over a ``RegionPriceModel``:
  each region's sub-model is forecast by its own forecaster.
* ``MarketForecaster`` — the same composition over a ``MarketPriceModel``
  (heterogeneous blocks: provider markets next to commitment pools).

All forecasters compose with the catalog exactly like ``catalog.at``:
``forecast_catalog(catalog, now_s, horizon_s)`` returns a snapshot whose
costs are the forecast mean hourly prices (Algorithm-1 order recomputed),
so downstream ``credit_priced`` / ``reservation_prices`` stack unchanged —
on a burstable market ``forecast_catalog(...).credit_priced(horizon_s)``
prices the *forecast effective $/throughput* of running over the horizon.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

from ..core.catalog import (Catalog, MarketPriceModel,
                            MeanRevertingPriceModel, PriceModel,
                            RegionPriceModel, TracePriceModel)


class PriceForecaster:
    """Static passthrough base: prices never move, the forecast is exact."""

    kind = "static"

    def mean_multipliers(self, n_types: int, now_s: float,
                         horizon_s: float) -> np.ndarray:
        """(K,) forecast mean price multiplier over [now, now + horizon]."""
        return np.ones(n_types)

    def anchor_multipliers(self, n_types: int, now_s: float) -> np.ndarray:
        """(K,) long-run mean multiplier as estimable *at* ``now`` (the
        reservation-price anchor strike prices are derived from).  Never
        uses information past ``now``."""
        return np.ones(n_types)

    # -- catalog composition -------------------------------------------------
    def _snapshot(self, catalog: Catalog, mult: np.ndarray) -> Catalog:
        base = catalog.base_costs if catalog.base_costs is not None \
            else catalog.costs
        costs = base * mult
        order = np.argsort(-costs, kind="stable")
        return dataclasses.replace(catalog, costs=costs, order_desc=order,
                                   base_costs=base)

    def forecast_catalog(self, catalog: Catalog, now_s: float,
                         horizon_s: float) -> Catalog:
        """Snapshot priced at the forecast mean over [now, now + horizon].
        Composes with ``credit_priced`` for burstable catalogs."""
        if self.kind == "static":
            return catalog  # exact: the identity, like Catalog.at
        return self._snapshot(catalog, self.mean_multipliers(
            len(catalog), now_s, horizon_s))

    def anchor_catalog(self, catalog: Catalog, now_s: float) -> Catalog:
        """Snapshot priced at the long-run mean (strike-price anchor)."""
        if self.kind == "static":
            return catalog
        return self._snapshot(catalog,
                              self.anchor_multipliers(len(catalog), now_s))

    # -- constructors --------------------------------------------------------
    @staticmethod
    def for_model(pm: Optional[PriceModel]) -> "PriceForecaster":
        if pm is None or pm.is_static:
            return PriceForecaster()
        if isinstance(pm, MarketPriceModel):
            return MarketForecaster(pm)
        if isinstance(pm, RegionPriceModel):
            return RegionForecaster(pm)
        if isinstance(pm, MeanRevertingPriceModel):
            return OUForecaster(pm)
        if isinstance(pm, TracePriceModel):
            return TraceForecaster(pm)
        return PersistenceForecaster(pm)

    @staticmethod
    def for_catalog(catalog: Catalog) -> "PriceForecaster":
        return PriceForecaster.for_model(catalog.price_model)


class PersistenceForecaster(PriceForecaster):
    """Fallback for unknown dynamic models: the current price persists, the
    anchor is the model's declared long-run mean."""

    kind = "persistence"

    def __init__(self, pm: PriceModel):
        self.pm = pm

    def mean_multipliers(self, n_types, now_s, horizon_s):
        return np.asarray(self.pm.multipliers_at(n_types, now_s), dtype=float)

    def anchor_multipliers(self, n_types, now_s):
        mm = np.asarray(self.pm.mean_multiplier, dtype=np.float64)
        return np.full(n_types, float(mm)) if mm.ndim == 0 \
            else np.broadcast_to(mm, (n_types,)).copy()


class OUForecaster(PriceForecaster):
    """Closed-form forecast of the mean-reverting (OU) log-price model.

    The model samples ``x_{i+1} = x_i + r (mu - x_i) + sigma eps``, so the
    conditional mean after k steps is ``mu + (x_0 - mu)(1 - r)^k`` — no
    simulation needed.  The horizon forecast averages the median path
    ``exp(E[x_k])`` over the horizon's steps, clipped to the model's price
    band, and the anchor is the stationary mean ``exp(mu) = discount``.
    """

    kind = "ou"

    def __init__(self, pm: MeanRevertingPriceModel):
        self.pm = pm

    def mean_multipliers(self, n_types, now_s, horizon_s):
        pm = self.pm
        x0 = np.log(pm.multipliers_at(n_types, now_s))
        mu = math.log(pm.discount)
        n_steps = max(int(math.ceil(max(horizon_s, 0.0) / pm.step_s)), 1)
        decay = (1.0 - pm.reversion) ** np.arange(n_steps)  # (S,)
        paths = np.exp(mu + np.outer(decay, x0 - mu))  # (S, K) median path
        return np.clip(paths, pm.discount / 10.0, 1.0).mean(axis=0)

    def anchor_multipliers(self, n_types, now_s):
        return np.full(n_types, self.pm.discount)


class TraceForecaster(PriceForecaster):
    """Lookahead-free empirical forecast of a replayed price trace.

    Consults only breakpoints at times <= now — never the trace's future.
    The current multiplier is assumed to persist for the median holding
    time observed so far, then revert to the ``quantile`` (default median)
    of the multipliers seen so far; the horizon forecast is the
    time-weighted blend of the two.  The anchor is the same empirical
    quantile, so both sides of the strike comparison are causal.
    """

    kind = "trace"

    def __init__(self, pm: TracePriceModel, quantile: float = 0.5):
        self.pm = pm
        assert 0.0 <= quantile <= 1.0
        self.quantile = float(quantile)

    def _history(self, now_s: float):
        """(times, values) of breakpoints at or before ``now`` (at least the
        first one, matching ``multipliers_at``'s clamp below the trace)."""
        pm = self.pm
        idx = int(np.searchsorted(pm.times_s, now_s, side="right"))
        idx = max(idx, 1)
        return pm.times_s[:idx], pm.multipliers[:idx]

    def _per_type(self, vals: np.ndarray, n_types: int) -> np.ndarray:
        if vals.ndim == 1:
            return np.broadcast_to(vals[:, None], (len(vals), n_types))
        return vals

    def mean_multipliers(self, n_types, now_s, horizon_s):
        times, vals = self._history(now_s)
        vals = self._per_type(np.asarray(vals, dtype=np.float64), n_types)
        current = vals[-1]
        anchor = np.quantile(vals, self.quantile, axis=0)
        holds = np.diff(times)
        persist_s = float(np.median(holds)) if holds.size else float("inf")
        # the current breakpoint has already been held for now - times[-1]
        persist_left = max(persist_s - (now_s - float(times[-1])), 0.0)
        h = max(float(horizon_s), 1e-9)
        w = min(persist_left, h) / h
        return w * current + (1.0 - w) * anchor

    def anchor_multipliers(self, n_types, now_s):
        _, vals = self._history(now_s)
        vals = self._per_type(np.asarray(vals, dtype=np.float64), n_types)
        return np.quantile(vals, self.quantile, axis=0)


class MarketForecaster(PriceForecaster):
    """Composite forecaster for heterogeneous region blocks
    (``MarketPriceModel``, the multi-provider catalog): block ``i`` covers
    ``counts[i]`` types forecast by its own sub-model's forecaster (static
    for commitment pools)."""

    kind = "multi-provider"

    def __init__(self, pm: MarketPriceModel,
                 subs: Optional[Sequence[PriceForecaster]] = None):
        self.pm = pm
        self.counts = pm.counts
        self.subs = tuple(subs) if subs is not None else tuple(
            PriceForecaster.for_model(m) for m in pm.models)

    def mean_multipliers(self, n_types, now_s, horizon_s):
        assert n_types == sum(self.counts)
        return np.concatenate([
            np.asarray(f.mean_multipliers(c, now_s, horizon_s),
                       dtype=np.float64)
            for f, c in zip(self.subs, self.counts)])

    def anchor_multipliers(self, n_types, now_s):
        assert n_types == sum(self.counts)
        return np.concatenate([
            np.asarray(f.anchor_multipliers(c, now_s), dtype=np.float64)
            for f, c in zip(self.subs, self.counts)])


class RegionForecaster(PriceForecaster):
    """Composite forecaster for a region-expanded catalog: each region's
    block is forecast by its own sub-model's forecaster."""

    kind = "multi-region"

    def __init__(self, pm: RegionPriceModel,
                 subs: Optional[Sequence[PriceForecaster]] = None):
        self.pm = pm
        self.n_base = pm.n_base
        self.subs = tuple(subs) if subs is not None else tuple(
            PriceForecaster.for_model(m) for m in pm.models)

    def _concat(self, fn) -> np.ndarray:
        return np.concatenate([np.asarray(fn(f), dtype=np.float64)
                               for f in self.subs])

    def mean_multipliers(self, n_types, now_s, horizon_s):
        assert n_types == self.n_base * len(self.subs)
        return self._concat(lambda f: f.mean_multipliers(
            self.n_base, now_s, horizon_s))

    def anchor_multipliers(self, n_types, now_s):
        assert n_types == self.n_base * len(self.subs)
        return self._concat(lambda f: f.anchor_multipliers(
            self.n_base, now_s))
