"""Instance-type catalog: static specs, spot-price dynamics, and regions.

The paper evaluates 21 AWS EC2 instance types from 3 families (P3 GPU
instances, C7i compute-optimized, R7i memory-optimized).  We encode the real
published specs/prices (us-east-1, on-demand, 2024).  Resources are the
3-vector (GPU, CPU, RAM-GB) used throughout the paper.  ``example_catalog``
reproduces Table 3 of the paper and is used by unit tests to check the
Algorithm-1 walkthrough verbatim.

Public API (see docs/ARCHITECTURE.md for how it plugs into scheduling):

* ``InstanceType`` / ``Catalog`` / ``aws_catalog()`` / ``table3_catalog()`` —
  the vectorized (capacities, costs, descending-cost order) view every
  pricing and packing routine consumes.
* ``PriceModel`` (``static`` / ``mean_reverting`` / ``trace``) — maps (base
  on-demand costs, time) → current hourly prices; ``catalog.at(time_s)``
  returns a snapshot with current costs and the Algorithm-1 order recomputed.
  The static model is the identity — ``at`` returns the catalog itself — so
  on-demand behaviour is bit-for-bit unchanged.
* ``Region`` / ``TransferMatrix`` / ``multi_region_catalog()`` — the
  multi-region layer: each region carries its own price model, base-price
  scale, preemption-hazard scale and optional instance-count capacity, and
  the catalog is expanded to region-qualified types (``region-0/p3.2xlarge``)
  whose prices move with *their region's* market.  ``catalog.at(time_s)``
  then returns region-qualified snapshots, and the cross-region
  ``TransferMatrix`` (egress $/GB + inter-region bandwidth) prices the
  checkpoint-transfer penalty a cross-region migration pays.
  ``dispersed_demo_regions()`` builds the bundled 3-region staggered
  cheap-window market used by benchmarks and tests.
* ``CreditModel`` — the burstable (AWS T-family / CASH) layer: an instance
  type may carry a credit model (baseline fraction, accrual rate, cap,
  launch credits).  A burstable instance runs at full speed while its
  credit balance lasts and is throttled to ``baseline_fraction`` once it
  hits zero — while its *hourly price never changes*.  The catalog exposes
  the state-dependent economics: ``avg_speed_over(horizon_s, balances)``
  forecasts the mean effective throughput of each type over a horizon and
  ``credit_priced(horizon_s, balances)`` returns a planning snapshot whose
  costs are effective $/throughput (cost ÷ forecast speed) so reservation
  prices and Algorithm 1 see a burstable type as cheap only while its
  forecast credits last.  ``burstable_demo_catalog()`` bundles the demo
  market (on-demand AWS types + discounted burstable c7i variants) used by
  ``benchmarks/bench_credits.py`` and the credit tests.

* ``CommitmentModel`` / ``Provider`` / ``multi_provider_catalog()`` — the
  commitment-portfolio + multi-provider layer: a provider is a market
  ``Region`` (all base types, its own price model / cost scale / hazard
  scale / egress rate) plus one *pool* ``Region`` per commitment — a
  1yr/3yr-style reserved-capacity pool holding only the committed type at
  the discounted rate, bounded by ``max_instances = pool_size`` so the
  existing region-cap machinery (planner budgets + simulator launch
  denial) bounds the pool.  A committed pool bills its discounted rate
  for every pool slot whether used or idle (the simulator's standing
  pool bill); overflow rides the provider's market region at the spot /
  on-demand ``PriceModel``.  The provider-aware ``TransferMatrix`` prices
  intra-provider moves at zero egress and near-zero transfer time, and
  cross-provider moves at the *source* provider's egress rate — so the
  existing S·D̂ > ΔM machinery automatically prices inter-provider
  arbitrage.  ``MarketPriceModel`` generalizes ``RegionPriceModel`` to
  heterogeneous region blocks (21-type markets next to 1-type pools).

Single-region catalogs carry ``regions=None`` and take none of the
multi-region code paths: their behaviour is bit-for-bit the PR-1 catalog.
Catalogs without burstable types carry ``credit_models=None`` and take none
of the credit code paths (``credit_priced`` is the identity there).
Catalogs without commitment pools carry no ``Region.commitment`` and take
none of the commitment code paths; a single-provider, commitment-free
``multi_provider_catalog`` is decision-identical to the equivalent
``multi_region_catalog`` (pinned in ``tests/test_policies.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np

RESOURCES = ("gpu", "cpu", "ram")
NUM_RESOURCES = len(RESOURCES)

# Instance families.  Per-family demand vectors (Table 7: CPU tasks need fewer
# vCPUs on C7i/R7i because of higher clocks) are indexed by these ids.
FAMILIES = ("p3", "c7i", "r7i")


@dataclasses.dataclass(frozen=True)
class CreditModel:
    """Burstable-instance credit dynamics (AWS T-family / CASH, Sharma 2020).

    Credits are measured in *full-speed hours*: one credit-hour buys one
    hour of full-throughput compute.  A busy instance drains its balance at
    ``duty − accrual_per_hour`` per hour (``duty`` is the busiest resident
    task's burst duty cycle, 1.0 by default); an idle one accrues at
    ``accrual_per_hour`` up to ``credit_cap_hours``.  At zero balance a
    busy instance is *throttled*: every resident task progresses at
    ``baseline_fraction`` of its normal rate while the hourly price is
    billed unchanged — the cost/throughput asymmetry credit-aware
    scheduling exploits.  While throttled the accrual is consumed by the
    baseline itself, so the balance stays pinned at zero until the
    instance goes idle.  Fresh instances start with
    ``launch_credit_hours`` (AWS T3 launch credits).

    ``accrual_per_hour`` defaults to ``baseline_fraction`` — the T-family
    identity (the baseline is exactly the sustainable duty).
    """

    baseline_fraction: float
    accrual_per_hour: Optional[float] = None
    credit_cap_hours: float = 2.0
    launch_credit_hours: float = 0.5

    def __post_init__(self):
        assert 0.0 < self.baseline_fraction < 1.0
        if self.accrual_per_hour is None:
            object.__setattr__(self, "accrual_per_hour",
                               self.baseline_fraction)

    @property
    def effective_launch_hours(self) -> float:
        """Launch balance actually granted: the cap bounds it, and planner
        (``Catalog.launch_balances``) and simulator must agree on it."""
        return min(self.launch_credit_hours, self.credit_cap_hours)

    def drain_per_hour(self, duty: float = 1.0) -> float:
        """Net balance change per busy hour (negative = accruing)."""
        return float(duty) - self.accrual_per_hour

    def burst_hours(self, balance_h: float, duty: float = 1.0) -> float:
        """Busy hours until a balance exhausts (inf for sustainable duty)."""
        d = self.drain_per_hour(duty)
        if d <= 0.0:
            return float("inf")
        return max(float(balance_h), 0.0) / d

    def speed(self, balance_h: float) -> float:
        """Instantaneous effective-throughput factor at a balance."""
        return 1.0 if balance_h > 1e-9 else self.baseline_fraction

    def avg_speed_over(self, balance_h: float, horizon_h: float,
                       duty: float = 1.0) -> float:
        """Forecast mean effective-throughput factor over ``horizon_h``
        busy hours starting from ``balance_h``: full speed while the
        balance lasts, ``baseline_fraction`` after."""
        if horizon_h <= 0.0:
            return self.speed(balance_h)
        t_full = self.burst_hours(balance_h, duty)
        if t_full >= horizon_h:
            return 1.0
        return (t_full + (horizon_h - t_full) * self.baseline_fraction) \
            / horizon_h


@dataclasses.dataclass(frozen=True)
class CommitmentModel:
    """A reserved-capacity commitment (1yr/3yr RI / savings-plan style).

    A commitment buys ``pool_size`` slots of one instance type at
    ``rate_fraction`` × the on-demand price.  The pool bills its
    discounted rate for *every* slot *every* hour, used or idle — the
    defining asymmetry of committed capacity: the marginal price of
    placing work on an already-paid slot is ≈ 0, while an idle slot is
    pure waste.  Overflow beyond the pool rides the provider's market
    (spot / on-demand ``PriceModel``).  Committed capacity is reserved:
    pool instances are never spot-preempted (the pool region carries
    ``hazard_scale = 0``).

    ``term_s`` is metadata for reporting (the nominal commitment term);
    billing inside a simulation run is per pool-hour regardless.
    """

    instance_type: str
    pool_size: int
    rate_fraction: float = 0.6
    term_s: float = 365.0 * 86400.0

    def __post_init__(self):
        assert self.pool_size >= 0
        assert 0.0 < self.rate_fraction <= 1.0
        assert self.term_s > 0.0

    def hourly_rate(self, on_demand_cost: float) -> float:
        """Committed $/hour for one pool slot of a type whose on-demand
        price is ``on_demand_cost``."""
        return float(on_demand_cost) * self.rate_fraction

    def standing_usd_per_hour(self, on_demand_cost: float) -> float:
        """The pool's standing bill: every slot, used or idle."""
        return self.pool_size * self.hourly_rate(on_demand_cost)


@dataclasses.dataclass(frozen=True)
class InstanceType:
    name: str
    family: str
    capacity: tuple  # (gpu, cpu, ram_gb)
    hourly_cost: float
    credit_model: Optional[CreditModel] = None  # burstable types only

    @property
    def family_id(self) -> int:
        return FAMILIES.index(self.family) if self.family in FAMILIES else 0


def _it(name, family, gpu, cpu, ram, cost):
    return InstanceType(name, family, (float(gpu), float(cpu), float(ram)), float(cost))


# 21 types: 3 P3 + 9 C7i + 9 R7i (matches the paper's setup).
AWS_CATALOG: tuple = (
    _it("p3.2xlarge", "p3", 1, 8, 61, 3.06),
    _it("p3.8xlarge", "p3", 4, 32, 244, 12.24),
    _it("p3.16xlarge", "p3", 8, 64, 488, 24.48),
    _it("c7i.large", "c7i", 0, 2, 4, 0.0893),
    _it("c7i.xlarge", "c7i", 0, 4, 8, 0.1785),
    _it("c7i.2xlarge", "c7i", 0, 8, 16, 0.357),
    _it("c7i.4xlarge", "c7i", 0, 16, 32, 0.714),
    _it("c7i.8xlarge", "c7i", 0, 32, 64, 1.428),
    _it("c7i.12xlarge", "c7i", 0, 48, 96, 2.142),
    _it("c7i.16xlarge", "c7i", 0, 64, 128, 2.856),
    _it("c7i.24xlarge", "c7i", 0, 96, 192, 4.284),
    _it("c7i.48xlarge", "c7i", 0, 192, 384, 8.568),
    _it("r7i.large", "r7i", 0, 2, 16, 0.1323),
    _it("r7i.xlarge", "r7i", 0, 4, 32, 0.2646),
    _it("r7i.2xlarge", "r7i", 0, 8, 64, 0.5292),
    _it("r7i.4xlarge", "r7i", 0, 16, 128, 1.0584),
    _it("r7i.8xlarge", "r7i", 0, 32, 256, 2.1168),
    _it("r7i.12xlarge", "r7i", 0, 48, 384, 3.1752),
    _it("r7i.16xlarge", "r7i", 0, 64, 512, 4.2336),
    _it("r7i.24xlarge", "r7i", 0, 96, 768, 6.3504),
    _it("r7i.48xlarge", "r7i", 0, 192, 1536, 12.7008),
)


def example_catalog() -> tuple:
    """Table 3(a) of the paper: it1..it4."""
    return (
        _it("it1", "p3", 4, 16, 244, 12.0),
        _it("it2", "p3", 1, 4, 61, 3.0),
        _it("it3", "c7i", 0, 8, 32, 0.8),
        _it("it4", "c7i", 0, 4, 16, 0.4),
    )


# --------------------------------------------------------------------------
# price models (spot-market layer)
# --------------------------------------------------------------------------
class PriceModel:
    """Maps (base on-demand costs, time) -> current hourly prices.

    The base class is the *static* on-demand model: prices never move and
    ``Catalog.at`` short-circuits to the catalog itself, so attaching
    ``PriceModel.static()`` is exactly equivalent to no model at all.

    Dynamic subclasses return a per-type multiplier vector that is a pure
    function of time (piecewise-constant on a precomputed grid), so scheduler
    and simulator always agree on the price at any instant and replays are
    deterministic regardless of event interleaving.
    """

    kind = "static"
    is_static = True
    mean_multiplier = 1.0

    def multipliers_at(self, n_types: int, time_s: float) -> np.ndarray:
        return np.ones(n_types)

    def prices_at(self, base_costs: np.ndarray, time_s: float) -> np.ndarray:
        return base_costs * self.multipliers_at(len(base_costs), time_s)

    def pressure_at(self, n_types: int, time_s: float) -> np.ndarray:
        """Price pressure: current multiplier relative to the long-run mean.
        > 1 means the market is tight (preemption hazard rises with it)."""
        return self.multipliers_at(n_types, time_s) / self.mean_multiplier

    # -- constructors -------------------------------------------------------
    @staticmethod
    def static() -> "PriceModel":
        return PriceModel()

    @staticmethod
    def mean_reverting(discount: float = 0.35, volatility: float = 0.10,
                       reversion: float = 0.05, step_s: float = 300.0,
                       horizon_s: float = 14 * 86400.0,
                       seed: int = 0) -> "MeanRevertingPriceModel":
        return MeanRevertingPriceModel(discount, volatility, reversion,
                                       step_s, horizon_s, seed)

    @staticmethod
    def trace(times_s: Sequence[float],
              multipliers: Sequence[float]) -> "TracePriceModel":
        return TracePriceModel(times_s, multipliers)


class MeanRevertingPriceModel(PriceModel):
    """Ornstein-Uhlenbeck log-price series around ``discount`` × on-demand.

    Each instance type gets an independent seeded path sampled once on a
    fixed ``step_s`` grid; queries step-interpolate (piecewise-constant) and
    hold the last value beyond ``horizon_s``.  Multipliers are clipped to
    [discount/10, 1.0] — AWS caps spot at the on-demand price.
    """

    kind = "mean-reverting"
    is_static = False

    def __init__(self, discount: float, volatility: float, reversion: float,
                 step_s: float, horizon_s: float, seed: int):
        assert 0.0 < discount <= 1.0
        self.discount = float(discount)
        self.volatility = float(volatility)
        self.reversion = float(reversion)
        self.step_s = float(step_s)
        self.horizon_s = float(horizon_s)
        self.seed = int(seed)
        self.mean_multiplier = float(discount)
        self._grids: Dict[int, np.ndarray] = {}  # n_types -> (N, K)

    def _grid(self, n_types: int) -> np.ndarray:
        g = self._grids.get(n_types)
        if g is None:
            rng = np.random.default_rng(self.seed)
            n_steps = int(self.horizon_s / self.step_s) + 1
            mu = np.log(self.discount)
            x = np.empty((n_steps, n_types))
            x[0] = mu
            eps = rng.standard_normal((n_steps - 1, n_types))
            for i in range(1, n_steps):
                x[i] = (x[i - 1] + self.reversion * (mu - x[i - 1])
                        + self.volatility * eps[i - 1])
            g = np.clip(np.exp(x), self.discount / 10.0, 1.0)
            self._grids[n_types] = g
        return g

    def multipliers_at(self, n_types: int, time_s: float) -> np.ndarray:
        g = self._grid(n_types)
        i = min(int(max(time_s, 0.0) / self.step_s), g.shape[0] - 1)
        return g[i]


class TracePriceModel(PriceModel):
    """Replay a recorded price trace: piecewise-constant multipliers.

    ``multipliers`` is (N,) for a market-wide series or (N, K) per-type.
    """

    kind = "trace"
    is_static = False

    def __init__(self, times_s: Sequence[float], multipliers: Sequence[float]):
        self.times_s = np.asarray(times_s, dtype=np.float64)
        self.multipliers = np.asarray(multipliers, dtype=np.float64)
        assert self.times_s.ndim == 1 and len(self.times_s) > 0
        assert self.multipliers.shape[0] == self.times_s.shape[0]
        assert np.all(np.diff(self.times_s) >= 0), "trace must be time-sorted"
        # per-type long-run mean for (N, K) traces so pressure (and hence the
        # preemption hazard) is unbiased for types whose own mean differs
        # from the market mean
        if self.multipliers.ndim == 2:
            self.mean_multiplier = self.multipliers.mean(axis=0)
        else:
            self.mean_multiplier = float(self.multipliers.mean())

    def multipliers_at(self, n_types: int, time_s: float) -> np.ndarray:
        i = int(np.searchsorted(self.times_s, time_s, side="right")) - 1
        i = max(i, 0)
        m = self.multipliers[i]
        if np.ndim(m) == 0:
            return np.full(n_types, float(m))
        return np.asarray(m)


# --------------------------------------------------------------------------
# regions (multi-region spot-arbitrage layer)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Region:
    """One cloud region (an independent spot market).

    price_model   : region-local price dynamics (None/static = on-demand)
    cost_scale    : multiplier on the base on-demand prices (static regional
                    price dispersion, e.g. us-west is 8 % dearer)
    hazard_scale  : multiplier on the preemption hazard of every instance in
                    the region — hazards are *region-correlated*: all types
                    in the region share the regional market's price pressure
                    scaled by this factor
    max_instances : per-region capacity (simultaneously alive instances);
                    None = unlimited.  The simulator denies launches beyond
                    it and the multi-region scheduler packs around full
                    regions.
    provider      : owning cloud provider (multi-provider catalogs only;
                    None = provider-less, the pre-commitment behaviour).
                    Regions of the same provider transfer data for free.
    commitment    : set on commitment-*pool* regions only: the pool bills
                    ``commitment.pool_size`` slots at the discounted rate
                    every hour regardless of use, and ``max_instances``
                    equals the pool size so the existing region-cap
                    machinery bounds it.  None = ordinary market region.
    """

    name: str
    price_model: Optional[PriceModel] = None
    cost_scale: float = 1.0
    hazard_scale: float = 1.0
    max_instances: Optional[int] = None
    provider: Optional[str] = None
    commitment: Optional[CommitmentModel] = None


@dataclasses.dataclass(frozen=True)
class TransferMatrix:
    """Cross-region data-movement cost model.

    egress_usd_per_gb : (R, R) — $/GB billed to the *source* region when a
                        checkpoint leaves it (diagonal is 0)
    bandwidth_gbps    : (R, R) — inter-region throughput in Gbit/s, used to
                        turn checkpoint size into transfer *time* (diagonal
                        is ignored: intra-region moves pay no transfer)
    """

    egress_usd_per_gb: np.ndarray
    bandwidth_gbps: np.ndarray

    @staticmethod
    def uniform(n_regions: int, egress_usd_per_gb: float = 0.02,
                bandwidth_gbps: float = 5.0) -> "TransferMatrix":
        """AWS-like defaults: $0.02/GB inter-region egress, ~5 Gbit/s per
        checkpoint stream."""
        e = np.full((n_regions, n_regions), float(egress_usd_per_gb))
        b = np.full((n_regions, n_regions), float(bandwidth_gbps))
        np.fill_diagonal(e, 0.0)
        return TransferMatrix(e, b)

    @staticmethod
    def for_providers(region_providers: Sequence[Optional[str]],
                      egress_usd_per_gb: Dict[str, float],
                      cross_bandwidth_gbps: float = 5.0,
                      intra_bandwidth_gbps: float = 50.0) -> "TransferMatrix":
        """Provider-aware transfer costs.

        Moves between regions of the *same* provider (a market and its
        commitment pools) pay zero egress over fat intra-provider links;
        cross-provider moves pay the **source** provider's egress rate
        (clouds bill data out, not in) over ``cross_bandwidth_gbps``.
        The S·D̂ > ΔM arbitrage machinery therefore prices inter-provider
        moves automatically through the existing ``task_move_cost`` path.
        """
        n = len(region_providers)
        e = np.zeros((n, n))
        b = np.full((n, n), float(intra_bandwidth_gbps))
        for i, p_i in enumerate(region_providers):
            for j, p_j in enumerate(region_providers):
                if i != j and p_i != p_j:
                    e[i, j] = float(egress_usd_per_gb.get(p_i, 0.0))
                    b[i, j] = float(cross_bandwidth_gbps)
        return TransferMatrix(e, b)

    def transfer_time_s(self, src: int, dst: int, size_gb: float) -> float:
        if src == dst:
            return 0.0
        return float(size_gb) * 8.0 / float(self.bandwidth_gbps[src, dst])

    def egress_usd(self, src: int, dst: int, size_gb: float) -> float:
        if src == dst:
            return 0.0
        return float(size_gb) * float(self.egress_usd_per_gb[src, dst])


class RegionPriceModel(PriceModel):
    """Composite price model for a region-expanded catalog.

    The expanded catalog lays types out as R consecutive blocks of
    ``n_base`` types; each block's multipliers come from that region's own
    model.  Preemption pressure is additionally scaled per region
    (``Region.hazard_scale``), which is what makes hazards
    region-correlated: every type in a region shares the regional market's
    pressure.
    """

    kind = "multi-region"

    def __init__(self, models: Sequence[PriceModel],
                 hazard_scales: Sequence[float], n_base: int):
        self.models = tuple(m if m is not None else PriceModel.static()
                            for m in models)
        self.hazard_scales = tuple(float(h) for h in hazard_scales)
        self.n_base = int(n_base)
        self.is_static = all(m.is_static for m in self.models)
        means = []
        for m in self.models:
            mm = np.asarray(m.mean_multiplier, dtype=np.float64)
            means.append(np.full(self.n_base, float(mm)) if mm.ndim == 0
                         else np.broadcast_to(mm, (self.n_base,)))
        self.mean_multiplier = np.concatenate(means)
        # the simulator samples prices no coarser than the finest sub-grid
        steps = [m.step_s for m in self.models if hasattr(m, "step_s")]
        if steps:
            self.step_s = min(steps)
        # trace sub-models are billed exactly at their own breakpoints
        times = sorted({float(t) for m in self.models
                        for t in np.asarray(getattr(m, "times_s", ()),
                                            dtype=np.float64).tolist()})
        if times:
            self.times_s = np.asarray(times, dtype=np.float64)

    def _check(self, n_types: int) -> None:
        assert n_types == self.n_base * len(self.models), \
            f"expected {self.n_base}x{len(self.models)} types, got {n_types}"

    def multipliers_at(self, n_types: int, time_s: float) -> np.ndarray:
        self._check(n_types)
        return np.concatenate([m.multipliers_at(self.n_base, time_s)
                               for m in self.models])

    def pressure_at(self, n_types: int, time_s: float) -> np.ndarray:
        self._check(n_types)
        return np.concatenate([m.pressure_at(self.n_base, time_s) * h
                               for m, h in zip(self.models,
                                               self.hazard_scales)])


class MarketPriceModel(PriceModel):
    """Composite price model for heterogeneous region blocks.

    Generalizes ``RegionPriceModel`` to catalogs whose regions hold
    *different* numbers of types — a provider's full 21-type market next
    to its 1-type commitment pools.  Block ``i`` covers ``counts[i]``
    consecutive types priced by ``models[i]`` with preemption pressure
    scaled by ``hazard_scales[i]`` (0 for reserved pools: committed
    capacity is never spot-preempted).

    Deliberately *not* a ``RegionPriceModel`` subclass: the forecaster
    dispatch (``PriceForecaster.for_model``) keys on the classes, and the
    uniform-block ``RegionForecaster`` cannot serve heterogeneous blocks.
    With one block this is numerically identical to a one-region
    ``RegionPriceModel`` (pinned in ``tests/test_policies.py``).
    """

    kind = "multi-provider"

    def __init__(self, models: Sequence[PriceModel],
                 hazard_scales: Sequence[float], counts: Sequence[int]):
        self.models = tuple(m if m is not None else PriceModel.static()
                            for m in models)
        self.hazard_scales = tuple(float(h) for h in hazard_scales)
        self.counts = tuple(int(c) for c in counts)
        assert len(self.models) == len(self.hazard_scales) \
            == len(self.counts)
        self.is_static = all(m.is_static for m in self.models)
        means = []
        for m, c in zip(self.models, self.counts):
            mm = np.asarray(m.mean_multiplier, dtype=np.float64)
            means.append(np.full(c, float(mm)) if mm.ndim == 0
                         else np.broadcast_to(mm, (c,)))
        self.mean_multiplier = np.concatenate(means)
        # same grid-propagation contract as RegionPriceModel: the simulator
        # samples no coarser than the finest sub-grid and exactly at trace
        # breakpoints
        steps = [m.step_s for m in self.models if hasattr(m, "step_s")]
        if steps:
            self.step_s = min(steps)
        times = sorted({float(t) for m in self.models
                        for t in np.asarray(getattr(m, "times_s", ()),
                                            dtype=np.float64).tolist()})
        if times:
            self.times_s = np.asarray(times, dtype=np.float64)

    def _check(self, n_types: int) -> None:
        assert n_types == sum(self.counts), \
            f"expected {sum(self.counts)} types in blocks {self.counts}, " \
            f"got {n_types}"

    def multipliers_at(self, n_types: int, time_s: float) -> np.ndarray:
        self._check(n_types)
        return np.concatenate([m.multipliers_at(c, time_s)
                               for m, c in zip(self.models, self.counts)])

    def pressure_at(self, n_types: int, time_s: float) -> np.ndarray:
        self._check(n_types)
        return np.concatenate([m.pressure_at(c, time_s) * h
                               for m, c, h in zip(self.models, self.counts,
                                                  self.hazard_scales)])


@dataclasses.dataclass(frozen=True)
class Catalog:
    """Vectorized view over a set of instance types.

    Attributes
    ----------
    capacities : (K, R) float64
    costs      : (K,)   float64 — current prices (== base for static models)
    order_desc : indices of types sorted by descending cost (Algorithm 1 order)
    price_model : optional time-varying price source; ``at(time_s)`` snapshots
    base_costs : on-demand reference prices (None until a snapshot is taken)
    regions    : multi-region catalogs only — tuple of ``Region``
    region_ids : (K,) int64 — region index of each type (None = single-region)
    base_index : (K,) int64 — index of each type in the un-expanded base
                 catalog (same base_index across regions = same hardware)
    transfer   : cross-region ``TransferMatrix`` (multi-region only)
    credit_models : burstable catalogs only — one ``Optional[CreditModel]``
                 per type (None entries = ordinary on-demand/spot types);
                 None when no type in the catalog is burstable
    """

    types: tuple
    capacities: np.ndarray
    costs: np.ndarray
    family_ids: np.ndarray
    order_desc: np.ndarray
    price_model: Optional[PriceModel] = None
    base_costs: Optional[np.ndarray] = None
    regions: Optional[tuple] = None
    region_ids: Optional[np.ndarray] = None
    base_index: Optional[np.ndarray] = None
    transfer: Optional[TransferMatrix] = None
    credit_models: Optional[tuple] = None

    @staticmethod
    def from_types(types: Sequence[InstanceType],
                   price_model: Optional[PriceModel] = None) -> "Catalog":
        types = tuple(types)
        caps = np.array([t.capacity for t in types], dtype=np.float64)
        costs = np.array([t.hourly_cost for t in types], dtype=np.float64)
        fam = np.array([t.family_id for t in types], dtype=np.int64)
        order = np.argsort(-costs, kind="stable")
        credits = None
        if any(t.credit_model is not None for t in types):
            credits = tuple(t.credit_model for t in types)
        return Catalog(types, caps, costs, fam, order, price_model,
                       credit_models=credits)

    def __len__(self) -> int:
        return len(self.types)

    def index_of(self, name: str) -> int:
        for i, t in enumerate(self.types):
            if t.name == name:
                return i
        raise KeyError(name)

    # -- regions -------------------------------------------------------------
    @property
    def is_multi_region(self) -> bool:
        return self.regions is not None

    def region_of(self, k: int) -> int:
        return int(self.region_ids[k])

    def region_index(self, name: str) -> int:
        for i, r in enumerate(self.regions):
            if r.name == name:
                return i
        raise KeyError(name)

    def region_type_mask(self, region: int) -> np.ndarray:
        """(K,) bool: which types live in ``region`` (index)."""
        return self.region_ids == int(region)

    # -- providers & commitments --------------------------------------------
    @property
    def has_commitments(self) -> bool:
        return self.regions is not None and \
            any(r.commitment is not None for r in self.regions)

    @property
    def has_providers(self) -> bool:
        return self.regions is not None and \
            any(r.provider is not None for r in self.regions)

    def commitment_pools(self) -> tuple:
        """((region_index, CommitmentModel), ...) over pool regions."""
        if self.regions is None:
            return ()
        return tuple((i, r.commitment) for i, r in enumerate(self.regions)
                     if r.commitment is not None)

    def commitment_type_mask(self) -> np.ndarray:
        """(K,) bool: types living in a commitment-pool region."""
        out = np.zeros(len(self), dtype=bool)
        for i, _cm in self.commitment_pools():
            out |= self.region_ids == i
        return out

    def provider_of(self, k: int) -> Optional[str]:
        """Owning provider of type ``k`` (None on provider-less catalogs)."""
        if self.regions is None or self.region_ids is None:
            return None
        return self.regions[int(self.region_ids[k])].provider

    def cheapest_copy(self, k: int,
                      type_mask: Optional[np.ndarray] = None) -> int:
        """Index of the cheapest same-hardware copy of type ``k`` across
        regions (``k`` itself on single-region catalogs or when every copy
        is masked out).  First-lowest-index tie-break."""
        if self.base_index is None:
            return int(k)
        cand = self.base_index == self.base_index[k]
        if type_mask is not None:
            cand = cand & np.asarray(type_mask)
        ks = np.nonzero(cand)[0]
        if ks.size == 0:
            return int(k)
        return int(ks[np.argmin(self.costs[ks])])

    # -- time-varying prices ------------------------------------------------
    def with_price_model(self, price_model: Optional[PriceModel]) -> "Catalog":
        return dataclasses.replace(self, price_model=price_model)

    def at(self, time_s: float) -> "Catalog":
        """Snapshot of the catalog priced at ``time_s``.

        Static (or absent) price models return ``self`` unchanged — the
        identity guarantees on-demand code paths stay bit-for-bit intact.
        """
        pm = self.price_model
        if pm is None or pm.is_static:
            return self
        base = self.base_costs if self.base_costs is not None else self.costs
        costs = pm.prices_at(base, time_s)
        order = np.argsort(-costs, kind="stable")
        return dataclasses.replace(self, costs=costs, order_desc=order,
                                   base_costs=base)

    def prices_between(self, t0: float, t1: Optional[float] = None) -> np.ndarray:
        """(K,) price vector in effect over the constant-price segment
        ``[t0, t1)``.

        Every price model here is piecewise-constant in time (OU grids,
        traces, and the region/market block compositions of both), so a
        caller that only crosses segment boundaries at its own PRICE_UPDATE
        events can bill a whole segment from one vector.  Unlike :meth:`at`,
        no catalog snapshot is built — no ``dataclasses.replace``, no
        re-sorted ``order_desc`` — which is what the simulator's billing
        path wants: the prices, nothing else.  ``t1`` documents the
        segment's intended extent; prices are evaluated at ``t0`` and the
        caller is responsible for not spanning a breakpoint (the simulator
        guarantees this by construction: PRICE_UPDATE events sit on every
        model step and trace breakpoint).

        With a static or absent model this returns ``self.costs`` itself —
        the same identity guarantee as :meth:`at`.
        """
        pm = self.price_model
        if pm is None or pm.is_static:
            return self.costs
        base = self.base_costs if self.base_costs is not None else self.costs
        return pm.prices_at(base, t0)

    # -- burstable credits --------------------------------------------------
    @property
    def is_burstable(self) -> bool:
        return self.credit_models is not None

    @property
    def launch_balances(self) -> np.ndarray:
        """(K,) launch-credit hours per type (0 for non-burstable types)."""
        if self.credit_models is None:
            return np.zeros(len(self))
        return np.array([0.0 if cm is None else cm.effective_launch_hours
                         for cm in self.credit_models])

    def avg_speed_over(self, horizon_s: float,
                       balances: Optional[np.ndarray] = None) -> np.ndarray:
        """(K,) forecast mean effective-throughput factor of each type over
        a ``horizon_s`` busy window: 1.0 for non-burstable types, the
        credit-adjusted average for burstable ones.  ``balances`` defaults
        to the launch-credit balance of a fresh instance of each type."""
        out = np.ones(len(self))
        if self.credit_models is None:
            return out
        bal = self.launch_balances if balances is None \
            else np.asarray(balances, dtype=np.float64)
        h = float(horizon_s) / 3600.0
        for k, cm in enumerate(self.credit_models):
            if cm is not None:
                out[k] = cm.avg_speed_over(float(bal[k]), h)
        return out

    def credit_priced(self, horizon_s: Optional[float],
                      balances: Optional[np.ndarray] = None) -> "Catalog":
        """Planning snapshot priced at effective $/throughput over a horizon.

        Each burstable type's cost is divided by its forecast mean speed
        (``avg_speed_over``), so a type whose credits will not last the
        horizon looks proportionally dearer to reservation prices and to
        Algorithm 1's descending-cost order — which is recomputed.  The
        identity for non-burstable catalogs (and ``horizon_s=None``), so
        on-demand/spot/multi-region paths are bit-for-bit unchanged.
        Billing always uses the *raw* costs: throttling never discounts
        the bill, which is the asymmetry this view prices in.
        """
        if self.credit_models is None or horizon_s is None:
            return self
        speed = self.avg_speed_over(horizon_s, balances)
        costs = self.costs / speed
        order = np.argsort(-costs, kind="stable")
        return dataclasses.replace(self, costs=costs, order_desc=order)


def aws_catalog(price_model: Optional[PriceModel] = None) -> Catalog:
    return Catalog.from_types(AWS_CATALOG, price_model)


def table3_catalog() -> Catalog:
    return Catalog.from_types(example_catalog())


# --------------------------------------------------------------------------
# multi-region construction
# --------------------------------------------------------------------------
def multi_region_catalog(regions: Sequence[Region],
                         base_types: Sequence[InstanceType] = AWS_CATALOG,
                         transfer: Optional[TransferMatrix] = None) -> Catalog:
    """Expand ``base_types`` across ``regions`` into a region-qualified catalog.

    Types are laid out as R consecutive blocks of the base catalog; names are
    qualified (``us-east/p3.2xlarge``), base prices are scaled by each
    region's ``cost_scale`` and move with its ``price_model`` (the composite
    ``RegionPriceModel`` keeps every region's market independent).  The
    default ``transfer`` is ``TransferMatrix.uniform(R)``.
    """
    regions = tuple(regions)
    base = tuple(base_types)
    assert regions, "need at least one region"
    types = []
    rids, bidx = [], []
    for r_i, region in enumerate(regions):
        for b_i, t in enumerate(base):
            types.append(InstanceType(f"{region.name}/{t.name}", t.family,
                                      t.capacity,
                                      t.hourly_cost * region.cost_scale,
                                      credit_model=t.credit_model))
            rids.append(r_i)
            bidx.append(b_i)
    pm: Optional[PriceModel] = None
    if any(r.price_model is not None for r in regions):
        pm = RegionPriceModel([r.price_model for r in regions],
                              [r.hazard_scale for r in regions], len(base))
    cat = Catalog.from_types(types, pm)
    if transfer is None:
        transfer = TransferMatrix.uniform(len(regions))
    return dataclasses.replace(
        cat, regions=regions,
        region_ids=np.asarray(rids, dtype=np.int64),
        base_index=np.asarray(bidx, dtype=np.int64), transfer=transfer)


# --------------------------------------------------------------------------
# multi-provider construction (commitment-portfolio layer)
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Provider:
    """One cloud provider: a market plus an optional commitment portfolio.

    price_model / cost_scale / hazard_scale / max_instances configure the
    provider's *market* region exactly like ``Region``;
    ``egress_usd_per_gb`` is the rate billed when data leaves this
    provider; ``commitments`` is a tuple of ``CommitmentModel`` — each
    becomes a dedicated reserved-capacity pool region.
    """

    name: str
    price_model: Optional[PriceModel] = None
    cost_scale: float = 1.0
    hazard_scale: float = 1.0
    max_instances: Optional[int] = None
    egress_usd_per_gb: float = 0.02
    commitments: tuple = ()


def multi_provider_catalog(providers: Sequence[Provider],
                           base_types: Sequence[InstanceType] = AWS_CATALOG,
                           transfer: Optional[TransferMatrix] = None,
                           cross_bandwidth_gbps: float = 5.0,
                           intra_bandwidth_gbps: float = 50.0) -> Catalog:
    """Expand ``base_types`` across provider markets + commitment pools.

    Each provider contributes one *market* region holding every base type
    at ``cost_scale`` × on-demand moving with its ``price_model``, plus
    one single-type *pool* region per commitment: ``pool_size`` slots of
    the committed type at the discounted static rate, hazard 0 (reserved
    capacity is never preempted), ``max_instances = pool_size``.  Region
    blocks are heterogeneous, so the composite is a ``MarketPriceModel``;
    ``base_index`` maps every copy (market or pool, any provider) of the
    same hardware together, so ``cheapest_copy`` / the arbitrage repack
    shop across providers and pools transparently.  The default transfer
    matrix is ``TransferMatrix.for_providers`` (intra-provider free).

    Composes with the whole existing catalog algebra: ``at(time_s)``
    snapshots the market blocks (pool blocks are static), and
    ``credit_priced`` / forecast snapshots work unchanged.  A
    single-provider, commitment-free call is decision-identical to
    ``multi_region_catalog`` with one region.
    """
    providers = tuple(providers)
    base = tuple(base_types)
    assert providers, "need at least one provider"
    by_name = {t.name: t for t in base}
    regions, blocks = [], []  # blocks[i] = list of (InstanceType, base_idx)
    for p in providers:
        market = Region(p.name, price_model=p.price_model,
                        cost_scale=p.cost_scale, hazard_scale=p.hazard_scale,
                        max_instances=p.max_instances, provider=p.name)
        regions.append(market)
        blocks.append([
            (InstanceType(f"{p.name}/{t.name}", t.family, t.capacity,
                          t.hourly_cost * p.cost_scale,
                          credit_model=t.credit_model), b_i)
            for b_i, t in enumerate(base)])
        for cm in p.commitments:
            t = by_name[cm.instance_type]  # KeyError = unknown committed type
            pool = Region(f"{p.name}/commit-{cm.instance_type}",
                          cost_scale=p.cost_scale * cm.rate_fraction,
                          hazard_scale=0.0, max_instances=cm.pool_size,
                          provider=p.name, commitment=cm)
            regions.append(pool)
            blocks.append([
                (InstanceType(f"{pool.name}/{t.name}", t.family, t.capacity,
                              cm.hourly_rate(t.hourly_cost * p.cost_scale),
                              credit_model=t.credit_model),
                 base.index(t))])
    types, rids, bidx = [], [], []
    for r_i, block in enumerate(blocks):
        for t, b_i in block:
            types.append(t)
            rids.append(r_i)
            bidx.append(b_i)
    pm: Optional[PriceModel] = None
    if any(r.price_model is not None for r in regions):
        pm = MarketPriceModel([r.price_model for r in regions],
                              [r.hazard_scale for r in regions],
                              [len(block) for block in blocks])
    cat = Catalog.from_types(types, pm)
    if transfer is None:
        transfer = TransferMatrix.for_providers(
            [r.provider for r in regions],
            {p.name: p.egress_usd_per_gb for p in providers},
            cross_bandwidth_gbps=cross_bandwidth_gbps,
            intra_bandwidth_gbps=intra_bandwidth_gbps)
    return dataclasses.replace(
        cat, regions=tuple(regions),
        region_ids=np.asarray(rids, dtype=np.int64),
        base_index=np.asarray(bidx, dtype=np.int64), transfer=transfer)


# --------------------------------------------------------------------------
# burstable demo market
# --------------------------------------------------------------------------
# Burstable variants cover the c7i sizes the Table-7 CPU workloads actually
# fit on (T-family stops well short of the 24/48xlarge metal tiers).
_BURSTABLE_SIZES = ("large", "xlarge", "2xlarge", "4xlarge", "8xlarge",
                    "12xlarge", "16xlarge")


def burstable_demo_catalog(price_fraction: float = 0.42,
                           baseline_fraction: float = 0.2,
                           launch_credit_hours: float = 0.5,
                           credit_cap_hours: float = 2.0,
                           price_model: Optional[PriceModel] = None
                           ) -> Catalog:
    """The bundled burstable market (``bench_credits`` + credit tests).

    All 21 on-demand AWS types, plus burstable ``t7i.*`` twins of the c7i
    compute tier at ``price_fraction`` × the on-demand price, each carrying
    a shared ``CreditModel``: a fresh instance bursts at full speed for
    ``launch_credit_hours / (1 − accrual)`` busy hours, then throttles to
    ``baseline_fraction``.  The defaults make the trap concrete: a
    burstable instance is 58 % cheaper per hour, but once throttled its
    effective price is ``price_fraction / baseline_fraction`` = 2.1× the
    on-demand twin — credit-blind reservation prices anchor to the cheap
    hourly sticker and ride the throttle; credit-aware ones burst while
    the forecast balance lasts and migrate off when it runs out.
    """
    cm = CreditModel(baseline_fraction=baseline_fraction,
                     credit_cap_hours=credit_cap_hours,
                     launch_credit_hours=launch_credit_hours)
    types = list(AWS_CATALOG)
    by_name = {t.name: t for t in AWS_CATALOG}
    for size in _BURSTABLE_SIZES:
        base = by_name[f"c7i.{size}"]
        types.append(InstanceType(f"t7i.{size}", base.family, base.capacity,
                                  base.hourly_cost * price_fraction,
                                  credit_model=cm))
    return Catalog.from_types(types, price_model)


def dispersed_demo_regions(n_regions: int = 3, low: float = 0.25,
                           high: float = 0.85, period_s: float = 3 * 3600.0,
                           horizon_s: float = 14 * 86400.0) -> tuple:
    """The bundled dispersed-price multi-region market (benchmarks + tests).

    Each region replays a staggered square-wave price trace: exactly one
    region is in its cheap window (``low`` × on-demand) at any instant while
    the others sit at ``high`` × on-demand, rotating every
    ``period_s / n_regions``.  A single-region scheduler therefore pays
    ``low`` only 1/R of the time; a multi-region one can chase the cheap
    window continuously — the price dispersion spot-arbitrage exploits.
    """
    step = period_s / n_regions
    times = np.arange(0.0, horizon_s, step)
    regions = []
    for r in range(n_regions):
        mult = np.where(np.arange(len(times)) % n_regions == r, low, high)
        regions.append(Region(f"region-{r}",
                              price_model=PriceModel.trace(times, mult)))
    return tuple(regions)
