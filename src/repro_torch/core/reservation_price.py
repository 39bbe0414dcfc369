"""Reservation price (§4.2) and throughput-normalized reservation price (§4.3).

RP(τ) = hourly cost of the cheapest instance type whose capacity fits τ's
demand (per-family demand vectors supported).  TNRP(τ, T) = tput(τ,T) · RP(τ);
for a task of a multi-task job j (§4.4):

    TNRP(τ, T) = RP(τ) − Σ_{τ'∈j} (1 − tput(τ,T)) · RP(τ')

which reduces to tput·RP for single-task jobs.

All price-consuming entry points accept an optional ``time_s``: when given,
the catalog is snapshotted via ``catalog.at(time_s)`` so reservation prices
track a spot market's current prices (static catalogs are unaffected).

They also accept an optional ``type_mask`` ((K,) bool): masked-out types are
treated as unavailable (priced at +inf).  Schedulers use it to restrict
packing to one region or to route around regions at capacity.  On a
region-expanded catalog (``core.catalog.multi_region_catalog``) plain
``reservation_prices`` already prices candidates across *all* regions — the
cheapest feasible region-qualified type wins; ``regional_reservation_prices``
exposes the per-region breakdown for region-level analyses (examples, tests,
price-dispersion diagnostics).

Burstable catalogs (``core.catalog.CreditModel``) add ``credit_horizon_s``:
when given, prices are taken from ``catalog.credit_priced(horizon_s)`` —
each burstable type's cost divided by its forecast mean effective
throughput over the horizon, starting from a fresh instance's launch
credits.  RP(τ) then answers the credit-aware question: what is the
cheapest *effective* $/throughput way to run τ for the next D̂ seconds?  A
burstable type whose credits outlast the horizon keeps its discounted
sticker price; one that would throttle mid-horizon is inflated toward
``cost / baseline_fraction``.  The identity on non-burstable catalogs.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .catalog import Catalog, FAMILIES
from .cluster_types import TaskSet


def feasibility_matrix(tasks: TaskSet, catalog: Catalog) -> np.ndarray:
    """(T, K) bool: does task t fit alone on an empty instance of type k?"""
    # Grouped by family instead of gathering a (T, K, R) float tensor: at
    # fleet scale (10⁵–10⁶ tasks × hundreds of region-qualified types) the
    # gather dominated RP computation; the per-family slices are (T, R).
    fam = catalog.family_ids  # (K,)
    out = np.empty((len(tasks), fam.shape[0]), dtype=bool)
    for fi in np.unique(fam):
        ks = np.nonzero(fam == fi)[0]
        d = tasks.demand_by_family[:, fi, None, :]  # (T, 1, R)
        out[:, ks] = np.all(d <= catalog.capacities[None, ks, :], axis=-1)
    return out


def _masked_costs(tasks: TaskSet, catalog: Catalog,
                  type_mask: Optional[np.ndarray]) -> np.ndarray:
    """(T, K) per-type cost with infeasible / masked-out types at +inf."""
    feas = feasibility_matrix(tasks, catalog)
    costs = np.where(feas, catalog.costs[None, :], np.inf)
    if type_mask is not None:
        costs = np.where(np.asarray(type_mask)[None, :], costs, np.inf)
    return costs


def reservation_prices(tasks: TaskSet, catalog: Catalog,
                       time_s: Optional[float] = None,
                       type_mask: Optional[np.ndarray] = None,
                       credit_horizon_s: Optional[float] = None) -> np.ndarray:
    """(T,) RP(τ).  Raises if some task fits no instance type (the paper
    removes such jobs from the trace; callers should filter first).
    ``credit_horizon_s`` prices burstable types at their credit-adjusted
    effective cost over the horizon (see module docstring)."""
    if time_s is not None:
        catalog = catalog.at(time_s)
    if credit_horizon_s is not None:
        catalog = catalog.credit_priced(credit_horizon_s)
    rp = _masked_costs(tasks, catalog, type_mask).min(axis=1)
    if np.any(~np.isfinite(rp)):
        bad = tasks.ids[~np.isfinite(rp)]
        raise ValueError(f"tasks {bad.tolist()} fit no instance type")
    return rp


def cheapest_type(tasks: TaskSet, catalog: Catalog,
                  time_s: Optional[float] = None,
                  type_mask: Optional[np.ndarray] = None,
                  credit_horizon_s: Optional[float] = None) -> np.ndarray:
    """(T,) index of the reservation-price instance type of each task."""
    if time_s is not None:
        catalog = catalog.at(time_s)
    if credit_horizon_s is not None:
        catalog = catalog.credit_priced(credit_horizon_s)
    return _masked_costs(tasks, catalog, type_mask).argmin(axis=1)


def regional_reservation_prices(tasks: TaskSet, catalog: Catalog,
                                time_s: Optional[float] = None) -> np.ndarray:
    """(T, R) cheapest feasible price of each task *within each region* of a
    multi-region catalog (+inf where a region has no feasible type).  The
    row-wise minimum equals the global ``reservation_prices``; the spread
    across columns is the per-task price dispersion arbitrage can capture."""
    if time_s is not None:
        catalog = catalog.at(time_s)
    assert catalog.is_multi_region, "needs a multi_region_catalog"
    costs = _masked_costs(tasks, catalog, None)
    n_regions = len(catalog.regions)
    out = np.full((len(tasks), n_regions), np.inf)
    for r in range(n_regions):
        out[:, r] = costs[:, catalog.region_type_mask(r)].min(axis=1)
    return out


def job_rp_sums(tasks: TaskSet, rp: np.ndarray) -> np.ndarray:
    """(T,) Σ_{τ'∈job(τ)} RP(τ') — the multi-task penalty base for each task."""
    # bincount accumulates in input order, so this matches the former
    # per-task dict loop bit for bit while staying O(T) vectorized.
    _, inv = np.unique(tasks.job_ids, return_inverse=True)
    sums = np.bincount(inv, weights=rp)
    return sums[inv]


def tnrp(rp: np.ndarray, tput: np.ndarray,
         job_rp: Optional[np.ndarray] = None) -> np.ndarray:
    """Vectorized TNRP for tasks with throughputs ``tput`` (both (T,)).

    With ``job_rp`` (Σ RP over the task's whole job), applies the §4.4
    multi-task definition; otherwise the single-task tput·RP definition.
    """
    if job_rp is None:
        return tput * rp
    return rp - (1.0 - tput) * job_rp
