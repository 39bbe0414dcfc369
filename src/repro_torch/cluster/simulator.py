"""High-fidelity event-driven simulator of a cloud-based cluster (paper §5).

Public API: ``Simulator(catalog, jobs, scheduler, SimConfig).run() ->
Metrics``.  The scheduler under test operates exactly as in a real
deployment: it sees only task demands, live placements and observed
throughputs (through the ThroughputMonitor hooks) and returns abstract
cluster configurations (docs/ARCHITECTURE.md walks through the full
scheduling-round data flow).  The simulated cloud models:

* instance acquisition + setup delays (Table 1; acquisition ~ 6+Exp(13) s
  clipped to [6, 83] (mean ≈ 19 s), setup ~ U[140, 251] s),
* per-workload checkpoint / launch migration delays (Table 7),
* co-location interference from the hidden ground-truth pairwise matrix
  (Figure 1 model) — tasks progress at the product of pairwise throughputs,
* data-parallel multi-task jobs progressing at the slowest task's rate,
* per-second billing from instance request to termination,
* optional instance failures (spot-style) for fault-tolerance experiments,
* an optional spot market (catalog with a dynamic ``PriceModel``): prices
  drift on a fixed update grid, billing integrates the current price, and
  instances face a per-type preemption hazard that rises with price pressure.
  A revocation arrives as a 2-minute notice (``preemption_notice_s``) visible
  to the scheduler via ``SchedulerView.revoked`` before the instance is
  reclaimed; whatever is still on the instance at reclaim time loses at most
  one checkpoint period of progress (same machinery as failures),
* an optional multi-region market (``core.catalog.multi_region_catalog``):
  billing is region-scoped (``Metrics.cost_by_region``), preemption hazards
  are region-correlated (every type shares its region's price pressure ×
  ``Region.hazard_scale``), a cross-region migration pays the checkpoint
  transfer time on top of the Table-7 checkpoint delay plus an egress fee
  billed exactly once per move (restoring a checkpoint stranded in another
  region after a reclaim/failure pays the same charge), and per-region
  ``max_instances`` capacity is enforced by denying launches into full
  regions (the tasks stay put / pending and are repacked next round),
* optional commitment pools (``core.catalog.multi_provider_catalog``):
  each pool region bills its discounted rate for every slot every hour —
  used or idle — as a standing bill integrated in ``_accrue`` (exactly
  once per pool-hour), while pool *instances* bill zero marginal; overflow
  rides the provider's market region at spot/on-demand prices.  Per-pool
  utilization/idle-waste integrals and per-provider ledgers
  (``Metrics.cost_by_provider``) account every dollar; the per-region
  launch caps bound pools, and a ``commitment_orders`` attribute on the
  scheduler (polled after every round, like ``admission``) grows pools
  monotonically mid-run — the inventory decision layered over the
  per-round RP decision,

* optional burstable instance types (catalog types carrying a
  ``core.catalog.CreditModel``): each burstable instance tracks a credit
  balance in full-speed hours — drained at ``duty − accrual`` per busy hour
  (``duty`` = the busiest resident RUNNING task's ``burst_duty``), accrued
  at ``accrual_per_hour`` while idle, capped.  When a busy instance's
  balance hits zero (a deterministic ``CREDIT_EXHAUST`` event — no RNG) it
  is *throttled*: every resident task progresses at ``baseline_fraction`` ×
  its interference-adjusted rate while billing continues at the unchanged
  hourly price — cost stays flat while throughput collapses, the asymmetry
  the credit-aware scheduler prices in.  Exhaustion is surfaced to the
  scheduler as a credit-pressure signal (``on_credit_pressure`` + an
  immediate extra round, mirroring spot revocation notices) and per-round
  via ``SchedulerView.instance_credits`` / ``SchedulerView.throttled``.
  Throughput observations from throttled instances are withheld from the
  monitor callbacks (credit state is cloud-visible à la CloudWatch, so the
  monitor can and does discard throttle-confounded samples instead of
  polluting the co-location interference table).  The executor never
  matches a *fresh* (zero-overlap) slot onto a throttled instance — asking
  for a new instance of a burstable type buys a new instance with launch
  credits, not someone's exhausted one.

* optional deferrable jobs (``Job.deferrable`` / ``Job.deadline_s``, the
  price-pressure autoscaling axis): an arrived job whose tasks a scheduler
  declines to place stays in a *pending* (not-admitted) state — zero
  billing, idle time accruing — until a config first assigns its tasks
  (the ARRIVE→PENDING→ADMIT transition, recorded per job).  The view
  surfaces ``SchedulerView.deferrable`` / ``deadline_s`` / ``pending``
  each round; a deterministic ``DEFER_DEADLINE`` event fires at each
  deferrable job's latest-start time (``repro.autoscale.latest_start_s``
  on its true duration) and — if the job is still pending — signals
  ``on_deadline_pressure`` plus an immediate extra round, the same
  pressure wiring spot notices and credit exhaustion use.  A scheduler
  re-deferring an admitted-but-unstarted job simply omits its tasks from
  the config: the executor *withdraws* the not-yet-launched placements
  (WAITING tasks only; launching/running tasks are never withdrawn).
  ``Metrics.deadline_misses`` / ``deferred_jobs`` / ``deferred_wait_s`` /
  ``withdrawals`` account for the axis.

* optional service jobs (``Job.service`` carrying a
  ``core.serving.ServiceSpec``, the online-serving axis): a service job is
  a fleet of interchangeable inference replicas running a fixed wall-clock
  window.  Its request load is a piecewise-constant profile (a
  deterministic ``RATE_UPDATE`` event fires at every breakpoint, so accrual
  segments never span a rate change); effective capacity is
  ``per_replica_rps`` × Σ replica throughputs (interference and credit
  throttling degrade serving exactly like batch iteration rates); each
  constant-rate segment bills ``λ·dt`` requests at the M/M/1-style p99
  ``base/(1 − λ/capacity)`` against the job's utility curve
  (``Metrics.slo_attainment`` / ``service_utility``).  When a job crosses
  into *utility risk* — load within the risk margin of its SLO-feasible
  utilization ceiling, or capacity short of load — an ``slo`` pressure
  signal fires on the rising edge through the shared wiring, and the view
  surfaces ``service`` / ``service_rps`` / ``service_capacity`` /
  ``slo_risk`` each round.

Every scheduler-visible pressure event — spot revocation notices, credit
exhaustion, deferral latest-start deadlines, serving utility risk —
travels one shared wiring: a ``PressureSignal`` published on the
simulator's ``PressureBus`` (``repro.policies.pressure``; delivered to
``scheduler.on_pressure`` exactly once) followed by an immediate extra
scheduling round, de-duplicated so coincident signals react in a single
round.

The spot, multi-region, credit, deferral and serving layers are strictly
additive: with a static (or absent) price model, a single-region catalog,
no burstable types, no deferrable/deadlined jobs and no service jobs no
extra events are scheduled and no extra RNG draws occur, so on-demand runs
are bit-for-bit identical to the seed simulator.  (The credit, deferral
and serving layers draw no randomness at all — each is a pure function of
the event trajectory.)

Progress accounting is lazy: every state change accrues Δt into cost /
allocation / idle-time integrals and re-projects job-completion events
(versioned to invalidate stale projections).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..autoscale.admission import latest_start_s
from ..core.catalog import Catalog, FAMILIES
from ..core.cluster_types import ClusterConfig, Job, TaskSet
from ..core.plan import LiveInstance, diff_configs
from ..core.scheduler import SchedulerBase, SchedulerView
from ..core.serving import p99_latency_ms_np, utility_np
from ..core.workloads import M_TRUE, WORKLOADS, checkpoint_size_gb
from ..obs import events as obs_ev
from ..policies.pressure import (CREDIT, DEADLINE, SLO, SPOT, PressureBus,
                                 PressureSignal)
from .fleet import SlotTable

# task states
PENDING, WAITING, CKPT, LAUNCH, RUNNING = range(5)


class _Col:
    """Descriptor for an entity attribute backed by a private slot and —
    while the entity is registered in a :class:`~repro.cluster.fleet.
    SlotTable` (vectorized mode) — by that table's column.

    ``through=True`` (accrual-integrated columns): sweeps advance the
    array only, so reads go through the table while registered and fall
    back to the private slot after deregistration (the table's ``remove``
    hands the final value back).  ``through=False`` (event-written
    columns): the private copy is always current, so reads stay cheap and
    writes mirror into the table for the sweeps to consume.
    """

    __slots__ = ("attr", "table_attr", "col", "through", "boolean")

    def __init__(self, attr: str, table_attr: str, col: str,
                 through: bool = True, boolean: bool = False):
        self.attr = attr
        self.table_attr = table_attr
        self.col = col
        self.through = through
        self.boolean = boolean

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        if self.through:
            t = getattr(obj, self.table_attr)
            if t is not None:
                return float(t.f[self.col][t.slot[obj._eid]])
        return getattr(obj, self.attr)

    def __set__(self, obj, v):
        setattr(obj, self.attr, v)
        t = getattr(obj, self.table_attr)
        if t is not None:
            cols = t.b if self.boolean else t.f
            cols[self.col][t.slot[obj._eid]] = v


@dataclasses.dataclass
class SimConfig:
    round_interval_s: float = 300.0
    migration_delay_scale: float = 1.0
    # override ground-truth interference: None -> M_TRUE; float x -> uniform
    # pairwise matrix with all off-diagonal entries x (Fig. 4 sweeps)
    uniform_interference: Optional[float] = None
    failure_mtbf_hours: float = 0.0  # 0 = no failures
    checkpoint_period_s: float = 600.0  # progress-loss bound on failure
    seed: int = 0
    max_time_s: float = 1e9
    # --- spot market (active only when the catalog has a dynamic PriceModel)
    price_update_interval_s: float = 300.0
    preemption_notice_s: float = 120.0  # revocation notice before reclaim
    preemption_hazard_per_hour: float = 0.0  # per-instance baseline; 0 = off


@dataclasses.dataclass
class _TaskState:
    task: object
    job_id: int
    workload: int
    state: int = PENDING
    src: Optional[int] = None  # instance where physically resident
    dst: Optional[int] = None  # instance assigned by the scheduler
    epoch: int = 0  # bumps invalidate in-flight ckpt/launch events
    migrations: int = 0
    placed_once: bool = False
    # multi-region: region where the durable checkpoint lives (for pricing a
    # cross-region restore after a reclaim/failure), and any pending restore
    # transfer time to add to the next launch
    ckpt_region: Optional[int] = None
    restore_transfer_s: float = 0.0


class _JobState:
    """Mutable per-job simulation state.

    The accrual-integrated accumulators (progress, idle/running time,
    served-request integrals) are :class:`_Col` attributes: in vectorized
    mode they live in the simulator's SoA job/service tables while the job
    is active, so sweeps advance whole columns at once and every reader —
    including tests inspecting ``js.iters_done`` mid-run — still sees
    current values.  In scalar mode (or once deregistered) they are plain
    attributes.
    """

    __slots__ = ("job", "version", "done_t", "arrived", "admitted_t",
                 "svc_risk", "svc_seg", "svc_times", "svc_rps",
                 "_rate", "_iters", "_idle", "_run_s", "_tputw",
                 "_svc_cap", "_svc_lam", "_req", "_ok", "_util",
                 "_jt", "_st", "_eid")

    # accrual-integrated: sweeps write the array, reads go through it
    iters_done = _Col("_iters", "_jt", "iters")
    idle_s = _Col("_idle", "_jt", "idle")
    running_s = _Col("_run_s", "_jt", "run_s")
    tput_weighted = _Col("_tputw", "_jt", "tputw")  # ∫ tput dt while running
    req_total = _Col("_req", "_st", "req")
    req_ok = _Col("_ok", "_st", "ok")
    util_integral = _Col("_util", "_st", "util")  # ∫ utility(p99) · λ dt
    # event-written: private copy always current, writes mirror to the table
    rate = _Col("_rate", "_jt", "rate", through=False)
    svc_capacity = _Col("_svc_cap", "_st", "cap", through=False)
    svc_lam = _Col("_svc_lam", "_st", "lam", through=False)

    def __init__(self, job: Job, arrived: bool = False):
        self.job = job
        self._eid = job.job_id
        self.version = 0
        self.done_t: Optional[float] = None
        self.arrived = arrived
        # deferral scenarios: instant a config first assigned this job's
        # tasks (the PENDING→ADMIT transition); None again if withdrawn
        self.admitted_t: Optional[float] = None
        # serving scenarios (jobs carrying a ServiceSpec): utility-risk
        # latch (SLO pressure fires on its rising edge), request-profile
        # segment cursor over the cached breakpoint arrays, current
        # effective fleet capacity / request rate, served-request integrals
        self.svc_risk = False
        self.svc_seg = -1
        self.svc_times: Optional[list] = None
        self.svc_rps: Optional[list] = None
        self._rate = 0.0
        self._iters = 0.0
        self._idle = 0.0
        self._run_s = 0.0
        self._tputw = 0.0
        self._svc_cap = 0.0
        self._svc_lam = 0.0
        self._req = 0.0
        self._ok = 0.0
        self._util = 0.0
        self._jt: Optional[SlotTable] = None
        self._st: Optional[SlotTable] = None


class _Instance:
    """Mutable per-instance simulation state; the burstable-credit balance
    is a :class:`_Col` backed by the simulator's credit table while the
    instance is alive in vectorized mode (see :class:`_JobState`)."""

    __slots__ = ("iid", "type_index", "request_t", "ready_t", "ready",
                 "terminated_t", "draining", "preempt_deadline", "assigned",
                 "residents", "alloc", "credit_seq",
                 "_credit", "_throttled", "_ct", "_eid")

    # burstable-credit state (types carrying a CreditModel only; the balance
    # is integrated lazily in _accrue, so it is current as of _last_accrue)
    credit_hours = _Col("_credit", "_ct", "bal")  # balance, full-speed hours
    # busy at zero balance -> baseline speed
    throttled = _Col("_throttled", "_ct", "throttled",
                     through=False, boolean=True)

    def __init__(self, iid: int, type_index: int,
                 request_t: float, ready_t: float):
        self.iid = iid
        self._eid = iid
        self.type_index = type_index
        self.request_t = request_t
        self.ready_t = ready_t
        self.ready = False
        self.terminated_t: Optional[float] = None
        self.draining = False
        self.preempt_deadline: Optional[float] = None  # revocation notice
        self.assigned: Set[int] = set()
        self.residents: Set[int] = set()  # outbound ckpt
        # running total of assigned tasks' demand on this instance's family,
        # maintained by Simulator._assign_task/_unassign_task so per-accrual
        # allocation accounting is O(alive instances), not O(alive tasks).
        # Demands are integer-valued, so incremental updates are float-exact.
        self.alloc = np.zeros(3)
        self._credit = 0.0
        self._throttled = False
        self.credit_seq = 0  # bumps invalidate in-flight CREDIT_EXHAUST
        self._ct: Optional[SlotTable] = None

    @property
    def alive(self) -> bool:
        return self.terminated_t is None


@dataclasses.dataclass
class Metrics:
    total_cost: float = 0.0
    instances_launched: int = 0
    migrations: int = 0
    n_tasks: int = 0
    n_jobs: int = 0
    jct_sum: float = 0.0
    idle_sum: float = 0.0
    running_sum: float = 0.0
    tput_weighted_sum: float = 0.0
    alloc_integral: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    cap_integral: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    ninst_integral: float = 0.0
    ntask_integral: float = 0.0
    failures: int = 0
    preemption_notices: int = 0
    preemptions: int = 0
    end_time: float = 0.0
    # multi-region accounting.  The ledgers are *always present* (empty
    # dicts on single-region runs, never None) and summary() gating is the
    # explicit has_regions flag — not dict truthiness, which conflated
    # "single-region run" with "multi-region run that spent nothing".
    has_regions: bool = False
    egress_cost: float = 0.0
    cross_region_migrations: int = 0
    capacity_denied: int = 0
    cost_by_region: Dict[str, float] = dataclasses.field(default_factory=dict)
    # provider/commitment accounting (multi-provider catalogs only; same
    # always-present, explicitly-gated contract as the region ledger)
    has_providers: bool = False
    cost_by_provider: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    has_commitments: bool = False
    commitment_cost: float = 0.0  # Σ standing pool bills (used or idle)
    commitment_idle_cost: float = 0.0  # unused pool-hours × discounted rate
    commitment_utilization: Dict[str, float] = dataclasses.field(
        default_factory=dict)  # pool region -> covered / capacity ∈ [0, 1]
    commitment_resizes: int = 0  # inventory-pass pool growths applied
    # burstable-credit accounting (populated only for burstable catalogs)
    has_credits: bool = False
    credit_exhaustions: int = 0
    throttled_s: float = 0.0  # Σ instance-seconds spent throttled
    # deferral accounting (populated only when some job is deferrable or
    # carries a deadline)
    has_deadlines: bool = False
    deadline_misses: int = 0
    deferred_jobs: int = 0  # admitted later than their first possible round
    deferred_wait_s: float = 0.0  # Σ arrival→admission wait, deferrable jobs
    withdrawals: int = 0  # re-deferred placements released before launch
    max_pending_jobs: int = 0  # peak not-yet-admitted deferrable queue length
    # serving accounting (populated only when some job carries a ServiceSpec)
    has_service: bool = False
    slo_requests_total: float = 0.0  # ∫ λ dt over service jobs
    slo_requests_ok: float = 0.0  # requests served with p99 ≤ target
    service_utility_sum: float = 0.0  # ∫ utility(p99) · λ dt
    slo_pressure_signals: int = 0  # utility-risk rising edges
    # flight-recorder event log (repro.obs.events.EventLog), set only when a
    # FlightRecorder was attached to the run; never enters summary()
    events: Optional[object] = None

    @property
    def slo_attainment(self) -> float:
        """Request-weighted fraction served with p99 at/below target."""
        return self.slo_requests_ok / max(self.slo_requests_total, 1e-9)

    @property
    def service_utility(self) -> float:
        """Request-weighted mean utility (1.0 = every request at full
        utility)."""
        return self.service_utility_sum / max(self.slo_requests_total, 1e-9)

    @property
    def avg_jct_hours(self) -> float:
        return self.jct_sum / max(self.n_jobs, 1) / 3600.0

    @property
    def avg_idle_hours(self) -> float:
        return self.idle_sum / max(self.n_jobs, 1) / 3600.0

    @property
    def norm_job_tput(self) -> float:
        return self.tput_weighted_sum / max(self.running_sum, 1e-9)

    @property
    def tasks_per_instance(self) -> float:
        return self.ntask_integral / max(self.ninst_integral, 1e-9)

    @property
    def migrations_per_task(self) -> float:
        return self.migrations / max(self.n_tasks, 1)

    def resource_allocation(self) -> Dict[str, float]:
        out = {}
        for i, r in enumerate(("gpu", "cpu", "ram")):
            out[r] = float(self.alloc_integral[i] / max(self.cap_integral[i], 1e-9))
        return out

    def summary(self) -> Dict[str, float]:
        d = {"total_cost": round(self.total_cost, 2),
             "avg_jct_hours": round(self.avg_jct_hours, 3),
             "avg_idle_hours": round(self.avg_idle_hours, 4),
             "norm_job_tput": round(self.norm_job_tput, 4),
             "tasks_per_instance": round(self.tasks_per_instance, 3),
             "migrations_per_task": round(self.migrations_per_task, 3),
             "instances_launched": self.instances_launched,
             "failures": self.failures,
             "preemptions": self.preemptions}
        d.update({f"alloc_{k}": round(v, 4)
                  for k, v in self.resource_allocation().items()})
        if self.has_regions:  # multi-region runs only
            d["egress_cost"] = round(self.egress_cost, 2)
            d["cross_region_migrations"] = self.cross_region_migrations
            d["capacity_denied"] = self.capacity_denied
            d.update({f"cost_{name}": round(v, 2)
                      for name, v in sorted(self.cost_by_region.items())})
        if self.has_providers:  # multi-provider runs only
            d.update({f"cost_provider_{name}": round(v, 2)
                      for name, v in sorted(self.cost_by_provider.items())})
        if self.has_commitments:  # commitment-pool runs only
            d["commitment_cost"] = round(self.commitment_cost, 2)
            d["commitment_idle_cost"] = round(self.commitment_idle_cost, 2)
            d["commitment_resizes"] = self.commitment_resizes
            d.update({f"util_{name}": round(v, 4) for name, v
                      in sorted(self.commitment_utilization.items())})
        if self.has_credits:  # burstable runs only
            d["credit_exhaustions"] = self.credit_exhaustions
            d["throttled_hours"] = round(self.throttled_s / 3600.0, 2)
        if self.has_deadlines:  # deferral/autoscale runs only
            d["deadline_misses"] = self.deadline_misses
            d["deferred_jobs"] = self.deferred_jobs
            d["deferred_wait_hours"] = round(self.deferred_wait_s / 3600.0, 2)
            d["withdrawals"] = self.withdrawals
            d["max_pending_jobs"] = self.max_pending_jobs
        if self.has_service:  # serving runs only
            d["slo_attainment"] = round(self.slo_attainment, 4)
            d["service_utility"] = round(self.service_utility, 4)
            d["served_requests"] = round(self.slo_requests_total)
            d["slo_signals"] = self.slo_pressure_signals
        return d


# event kinds (ordering within same timestamp: arrivals & completions before
# rounds so the round sees fresh state; price updates, preemption reclaims,
# credit exhaustions, deferral deadlines and serving rate updates also
# precede rounds so the scheduler reacts to current prices, notices,
# throttle state, latest-start signals and request load)
(ARRIVAL, INSTANCE_READY, CKPT_DONE, LAUNCH_DONE, JOB_DONE, FAILURE,
 PRICE_UPDATE, PREEMPT_FIRE, CREDIT_EXHAUST, DEFER_DEADLINE, RATE_UPDATE,
 ROUND) = range(12)

# Event kinds whose coincident bursts collapse into one accrual sweep in
# run(): their handlers never pop events themselves, never rebind the heap,
# and only push same-timestamp events of later-sorting kinds (ROUND) or
# strictly-future events — so handling the whole burst after a single
# _accrue is observably identical to the one-pop-one-accrue reference
# (the in-between accruals were dt=0 no-ops).  JOB_DONE is deliberately
# excluded: its handler can filter + re-heapify the event heap.
_COALESCE = frozenset((ARRIVAL, PRICE_UPDATE, RATE_UPDATE, DEFER_DEADLINE))


class Simulator:
    def __init__(self, catalog: Catalog, jobs: Sequence[Job],
                 scheduler: SchedulerBase, cfg: Optional[SimConfig] = None,
                 recorder=None, vectorized: bool = True):
        self.catalog = catalog
        # Vectorized accrual core (docs/ARCHITECTURE.md, "The simulator at
        # fleet scale").  vectorized=False keeps the original per-entity
        # scalar sweeps as the pinned reference: summaries agree exactly on
        # counters and within 1e-9 relative on reassociated float sums.
        self._vec = bool(vectorized)
        self.scheduler = scheduler
        self.cfg = cfg or SimConfig()
        # Flight recorder (repro.obs.FlightRecorder) — a pure observer: every
        # emission below is gated on self._ev, so recorder-less runs execute
        # the identical instruction stream (pinned by tests/test_obs.py).
        self._rec = recorder
        self._ev = None if recorder is None else recorder.events
        self._round_index = 0
        self.rng = np.random.default_rng(self.cfg.seed)
        self.jobs: Dict[int, _JobState] = {}
        self.tasks: Dict[int, _TaskState] = {}
        self.instances: Dict[int, _Instance] = {}
        # fleet-scale indices: the alive (insertion-ordered, so sweeps stay
        # bit-identical to filtering self.instances) and not-yet-done
        # subsets, plus per-region alive counts — long traces accumulate
        # dead instances/jobs and the per-event sweeps were O(history)
        self._alive: Dict[int, _Instance] = {}
        self._active_jobs: Dict[int, _JobState] = {}
        self._iid = itertools.count()
        self._seq = itertools.count()
        self._heap: List[Tuple[float, int, int, int, tuple]] = []
        self._seeding = True  # __init__ batches pushes, then heapifies once
        self._round_scheduled_at: float = -1.0
        self._pressure_round_at: float = -1.0  # immediate-round de-dup
        # One bus for every pressure wiring (spot / credit / deadline); the
        # scheduler's on_pressure fans the signal out to its policy stack
        # and the legacy per-kind hooks.
        self.pressure_bus = PressureBus()
        self.pressure_bus.subscribe(scheduler.on_pressure)
        self.now = 0.0
        self._last_accrue = 0.0
        self.metrics = Metrics()
        if self._ev is not None:
            self.metrics.events = self._ev
        if self.cfg.uniform_interference is not None:
            x = float(self.cfg.uniform_interference)
            self._m = np.full_like(M_TRUE, x)
            np.fill_diagonal(self._m, 1.0)
        else:
            self._m = M_TRUE
        # Spot market: active only with a dynamic price model on the catalog.
        # All spot randomness comes from a dedicated stream so the main RNG's
        # draw sequence (acquisition/setup/failures) is untouched.
        pm = catalog.price_model
        self._spot = pm is not None and not pm.is_static
        self._jobs_outstanding = len(jobs)
        # Multi-region: region-scoped billing, cross-region migration costs,
        # per-region capacity.  All gated on catalog.regions so single-region
        # runs take none of these paths.
        self._regions = catalog.regions
        if self._regions is not None:
            self._region_ids = catalog.region_ids
            self._region_name_of_type = [self._regions[r].name
                                         for r in self._region_ids.tolist()]
            self._provider_of_type = [self._regions[r].provider
                                      for r in self._region_ids.tolist()]
            self.metrics.has_regions = True
            self.metrics.cost_by_region = {r.name: 0.0 for r in self._regions}
            # mutable per-region launch limits: commitment re-sizes grow
            # pool caps at runtime (frozen Region.max_instances is only the
            # initial value)
            self._region_limits = [r.max_instances for r in self._regions]
            providers = [r.provider for r in self._regions]
            if any(p is not None for p in providers):
                self.metrics.has_providers = True
                self.metrics.cost_by_provider = {
                    p: 0.0 for p in dict.fromkeys(providers)
                    if p is not None}
        # Commitment pools: each pool region bills its discounted rate for
        # every slot every hour (standing bill, integrated in _accrue) while
        # its instances bill zero marginal — the pool-hour is paid exactly
        # once.  All paths gated on self._commit so commitment-free catalogs
        # are bit-for-bit untouched.
        self._pools = catalog.commitment_pools() \
            if self._regions is not None else ()
        self._commit = bool(self._pools)
        if self._commit:
            self.metrics.has_commitments = True
            self._pool_type = catalog.commitment_type_mask()
            self._pool_size: Dict[int, int] = {}
            self._pool_rate: Dict[int, float] = {}
            self._pool_covered_s: Dict[int, float] = {}
            self._pool_capacity_s: Dict[int, float] = {}
            for ri, cm in self._pools:
                ks = np.nonzero(catalog.region_ids == ri)[0]
                assert ks.size == 1, \
                    "a commitment pool region holds exactly one type"
                self._pool_size[ri] = int(cm.pool_size)
                self._pool_rate[ri] = float(catalog.costs[int(ks[0])])
                self._pool_covered_s[ri] = 0.0
                self._pool_capacity_s[ri] = 0.0
        # Burstable credits: active only when some catalog type carries a
        # CreditModel.  Deterministic (no RNG); all paths gated on
        # self._credits so other catalogs are bit-for-bit untouched.
        self._credit_models = catalog.credit_models
        self._credits = self._credit_models is not None
        if self._credits:
            self.metrics.has_credits = True
        # Deferrable jobs (price-pressure autoscaling): active only when the
        # trace carries deferrable or deadlined jobs.  Deterministic (no
        # RNG); all paths gated on self._deferrals so other traces are
        # bit-for-bit untouched.  Each deferrable deadlined job gets a
        # DEFER_DEADLINE event at its latest-start time — if still pending
        # then, the deadline-pressure signal fires (callback + immediate
        # round) so the admission bound is honoured between rounds.
        self._deferrals = any(j.deferrable or j.deadline_s is not None
                              for j in jobs)
        if self._deferrals:
            self.metrics.has_deadlines = True
            # the backstop must agree with the live controller's bound, so
            # read its (possibly customized) margin/overhead when present
            ctl = getattr(scheduler, "admission", None)
            ls_kw = {} if ctl is None else dict(
                margin=ctl.margin, overhead_s=ctl.overhead_s)
            for job in jobs:
                if job.deferrable and job.deadline_s is not None:
                    t = max(latest_start_s(job.deadline_s, job.duration_s,
                                           **ls_kw),
                            job.arrival_time)
                    if t <= self.cfg.max_time_s:
                        self._push(t, DEFER_DEADLINE, (job.job_id,))
        # Serving axis: active only when some job carries a ServiceSpec.
        # Deterministic (no RNG); all paths gated on self._serving so batch
        # traces are bit-for-bit untouched.  Each service job gets a
        # RATE_UPDATE event at every request-profile breakpoint inside its
        # window, so accrual segments never span a rate change and utility
        # risk is re-evaluated the instant load shifts.
        self._serving = any(j.service is not None for j in jobs)
        if self._serving:
            self.metrics.has_service = True
            # per-profile breakpoint arrays, materialized once: _svc_rate
            # advances a per-job cursor over these lists instead of
            # re-searching the piecewise representation on every accrual
            # segment (profiles are shared across jobs, hence keyed by id)
            self._profile_segs: Dict[int, Tuple[list, list]] = {}
            for job in jobs:
                if job.service is None:
                    continue
                prof = job.service.requests
                if id(prof) not in self._profile_segs:
                    t_arr, r_arr = prof.segments()
                    self._profile_segs[id(prof)] = (t_arr.tolist(),
                                                    r_arr.tolist())
                end = min(job.arrival_time + job.duration_s,
                          self.cfg.max_time_s)
                for t in prof.breakpoints_between(job.arrival_time, end):
                    self._push(float(t), RATE_UPDATE, (job.job_id,))
        # SoA fleet state for vectorized sweeps: per-type alive counts and
        # fleet-wide allocation totals (einsum inputs), plus swap-remove
        # tables holding the accrual-integrated columns of live entities.
        # Maintained unconditionally cheap at the event handlers; consumed
        # only by _accrue_vec.
        if self._vec:
            self._type_alive = np.zeros(len(catalog), dtype=np.int64)
            self._alloc_total = np.zeros(3)
            self._assigned_total = 0
            self._jtab = SlotTable(("rate", "iters", "idle", "run_s",
                                    "tputw"))
            self._ctab = SlotTable(("bal", "net", "cap_h"),
                                   ("throttled",)) if self._credits else None
            self._stab = SlotTable(("lam", "cap", "base_ms", "target_ms",
                                    "soft_ms", "floor", "req", "ok",
                                    "util")) if self._serving else None
        if self._spot:
            self._spot_rng = np.random.default_rng(self.cfg.seed + 0x5B07)
            self._cur_costs = pm.prices_at(catalog.costs, 0.0)
            self._last_price_update = 0.0
            # never sample coarser than the model's own grid (an OU model
            # with step_s below the configured interval would otherwise be
            # billed with prices up to one interval stale)
            self._price_interval = min(self.cfg.price_update_interval_s,
                                       getattr(pm, "step_s",
                                               self.cfg.price_update_interval_s))
            self._push(self._price_interval, PRICE_UPDATE, (True,))
            # trace models change price at their own breakpoints; bill those
            # exactly instead of lagging up to one update interval
            for t in np.asarray(getattr(pm, "times_s", ()), dtype=np.float64):
                if 0.0 < t <= self.cfg.max_time_s:
                    self._push(float(t), PRICE_UPDATE, (False,))
        for job in jobs:
            self._push(job.arrival_time, ARRIVAL, (job,))
        self.metrics.n_jobs = len(jobs)
        self.metrics.n_tasks = sum(j.n_tasks for j in jobs)
        if self._regions is not None:
            self._region_alive = [0] * len(self._regions)
        # one heapify over the seeded events instead of per-event pushes;
        # pop order is unchanged (the unique seq makes ordering total)
        heapq.heapify(self._heap)
        self._seeding = False

    # ------------------------------------------------------------------ util
    def _push(self, t: float, kind: int, payload: tuple):
        entry = (t, kind, next(self._seq), payload)
        if self._seeding:
            self._heap.append(entry)
        else:
            heapq.heappush(self._heap, entry)

    def _live_instances(self) -> List[_Instance]:
        return [i for i in self._alive.values() if not i.draining]

    def _task_demand(self, inst: _Instance, tid: int) -> np.ndarray:
        fam = FAMILIES[self.catalog.types[inst.type_index].family_id]
        return np.array(self.tasks[tid].task.demand_for_family(fam))

    def _assign_task(self, inst: _Instance, tid: int) -> None:
        if tid not in inst.assigned:
            inst.assigned.add(tid)
            d = self._task_demand(inst, tid)
            inst.alloc += d
            if self._vec and inst.alive:
                self._assigned_total += 1
                self._alloc_total += d

    def _unassign_task(self, inst: _Instance, tid: int) -> None:
        if tid in inst.assigned:
            inst.assigned.discard(tid)
            d = self._task_demand(inst, tid)
            inst.alloc -= d
            if self._vec and inst.alive:
                self._assigned_total -= 1
                self._alloc_total -= d

    # ------------------------------------------------------------ accounting
    def _bill_type(self, amt: float, k: int,
                   category: str = obs_ev.COST_INSTANCE) -> None:
        """Bill ``amt`` attributed to instance type ``k`` on every ledger
        (total, per-region, per-provider; plus the flight recorder's
        per-(category, key) cost ledger when one is attached)."""
        m = self.metrics
        m.total_cost += amt
        if self._regions is not None:
            m.cost_by_region[self._region_name_of_type[k]] += amt
            p = self._provider_of_type[k]
            if p is not None:
                m.cost_by_provider[p] += amt
        if self._ev is not None:
            key = (self._region_name_of_type[k] if self._regions is not None
                   else self.catalog.types[k].name)
            self._ev.record_cost(category, key, amt)

    def _bill_region(self, amt: float, ri: int,
                     category: str = obs_ev.COST_INSTANCE) -> None:
        """Bill ``amt`` attributed to region ``ri`` on every ledger."""
        m = self.metrics
        m.total_cost += amt
        m.cost_by_region[self._regions[ri].name] += amt
        p = self._regions[ri].provider
        if p is not None:
            m.cost_by_provider[p] += amt
        if self._ev is not None:
            self._ev.record_cost(category, self._regions[ri].name, amt)

    def _accrue(self, now: float):
        dt = now - self._last_accrue
        if dt <= 0:
            self._last_accrue = now
            return
        if self._vec:
            self._accrue_vec(dt)
        else:
            self._accrue_scalar(dt)
        self._last_accrue = now

    def _accrue_scalar(self, dt: float) -> None:
        """Reference accrual sweep: a Python loop over live entities.

        This is the pinned semantics the vectorized sweep must reproduce;
        the hot loops touch the private slots directly (``js._iters`` etc.
        — identical arithmetic, no descriptor dispatch) since in scalar
        mode the tables are absent and the privates are the truth.
        """
        m = self.metrics
        for inst in self._alive.values():
            m.ninst_integral += dt
            m.ntask_integral += len(inst.assigned) * dt
            m.cap_integral += self.catalog.capacities[inst.type_index] * dt
            m.alloc_integral += inst.alloc * dt
            if self._credits:  # integrate the credit balance (billing is NOT
                self._credit_integrate(inst, dt)  # touched: cost stays flat)
                if inst._throttled:
                    m.throttled_s += dt
            if self._spot and not (self._commit
                                   and self._pool_type[inst.type_index]):
                # integrate the piecewise-constant spot price; pool
                # instances bill zero marginal (the standing bill below
                # already paid their slot)
                amt = dt / 3600.0 * self._cur_costs[inst.type_index]
                self._bill_type(amt, inst.type_index)
        if self._commit:
            self._accrue_pools(dt)
        for js in self._active_jobs.values():
            if js._rate > 0:
                js._iters += js._rate * dt
                js._run_s += dt
                js._tputw += js._rate * dt
            else:
                js._idle += dt
            if self._serving and js.job.service is not None:
                # rate is constant on the segment (RATE_UPDATE events sit on
                # every profile breakpoint), so λ at the segment start holds
                self._svc_accrue(js, dt)

    def _accrue_vec(self, dt: float) -> None:
        """One accrual sweep as array programs over the SoA fleet state.

        Equivalent to :meth:`_accrue_scalar` up to float reassociation:
        fleet integrals and spot bills become per-type segment sums
        (count × price instead of repeated ``+=``) and metric totals
        become array reductions, which may drift by ~1 ulp per sweep
        (the documented ≤1e-9 relative tolerance), while credit balances
        and per-job progress advance with the *same elementwise
        arithmetic* as the scalar path and stay bit-identical — so every
        scheduling decision, and hence the event trajectory, matches the
        reference exactly.
        """
        m = self.metrics
        n = len(self._alive)
        if n:
            m.ninst_integral += n * dt
            m.ntask_integral += self._assigned_total * dt
            # per-type capacity integral in one (K,)·(K,3) contraction
            m.cap_integral += (self._type_alive
                               @ self.catalog.capacities) * dt
            m.alloc_integral += self._alloc_total * dt
            if self._credits and self._ctab.n:
                ct = self._ctab
                cn = ct.n
                thr = ct.b["throttled"][:cn]
                n_thr = int(np.count_nonzero(thr))
                if n_thr:
                    m.throttled_s += n_thr * dt
                # same min/max/fma chain as _credit_integrate, elementwise;
                # the `net` column is refreshed by _credit_reproject at
                # every RUNNING-set change, so it is current by invariant
                bal = ct.f["bal"][:cn]
                nb = np.minimum(
                    ct.f["cap_h"][:cn],
                    np.maximum(0.0, bal + ct.f["net"][:cn] * dt / 3600.0))
                np.copyto(bal, nb, where=~thr)
            if self._spot:
                counts = self._type_alive
                if self._commit:
                    counts = np.where(self._pool_type, 0, counts)
                amt = dt / 3600.0 * self._cur_costs
                for k in np.nonzero(counts)[0].tolist():
                    self._bill_type(float(counts[k]) * float(amt[k]), k)
        if self._commit:
            self._accrue_pools(dt)
        jt = self._jtab
        jn = jt.n
        if jn:
            r = jt.f["rate"][:jn]
            run = r > 0.0
            adv = np.where(run, r * dt, 0.0)  # adding +0.0 on idle lanes
            jt.f["iters"][:jn] += adv         # is bit-exact (values >= 0)
            jt.f["tputw"][:jn] += adv
            jt.f["run_s"][:jn] += np.where(run, dt, 0.0)
            jt.f["idle"][:jn] += np.where(run, 0.0, dt)
        if self._serving and self._stab.n:
            self._svc_accrue_vec(dt)

    def _accrue_pools(self, dt: float) -> None:
        """Standing pool bills: every slot, used or idle, exactly once per
        pool-hour — plus the utilization integrals.  Shared verbatim by
        both accrual paths (few pools, so the loop is already O(1)-ish)."""
        m = self.metrics
        hours = dt / 3600.0
        for ri, _cm in self._pools:
            size = self._pool_size[ri]
            amt = hours * size * self._pool_rate[ri]
            m.commitment_cost += amt
            self._bill_region(amt, ri, obs_ev.COST_COMMITMENT)
            self._pool_capacity_s[ri] += dt * size
            self._pool_covered_s[ri] += dt * min(
                self._region_alive[ri], size)

    def _svc_accrue(self, js: _JobState, dt: float) -> None:
        """Bill a constant-rate segment of served requests against the
        job's utility curve at the current capacity headroom.  ``js.
        svc_lam`` is maintained by _touch_service at arrival and at every
        RATE_UPDATE (one sits on each profile breakpoint), so it equals
        ``rate_at`` of the segment start without a search."""
        spec = js.job.service
        lam = js._svc_lam
        if lam <= 0.0:
            return
        lat = spec.p99_ms(lam, js._svc_cap)
        req = lam * dt
        m = self.metrics
        js._req += req
        m.slo_requests_total += req
        if lat <= spec.utility.target_p99_ms + 1e-9:
            js._ok += req
            m.slo_requests_ok += req
        u = spec.utility.utility(lat)
        js._util += u * req
        m.service_utility_sum += u * req

    def _svc_accrue_vec(self, dt: float) -> None:
        """Batched :meth:`_svc_accrue` across the whole service fleet: one
        latency/utility evaluation over the lam/cap columns.  Per-job
        integrals use the identical per-lane arithmetic (bit-exact); only
        the metric totals are array reductions (reassociated sums)."""
        st = self._stab
        sn = st.n
        lam = st.f["lam"][:sn]
        active = lam > 0.0
        if not active.any():
            return
        cap = st.f["cap"][:sn]
        target = st.f["target_ms"][:sn]
        pos = cap > 0.0
        # rho >= 1 on any lane with no capacity -> saturated -> inf latency,
        # matching ServiceSpec.p99_ms's capacity_rps <= 0 branch
        rho = np.where(pos, lam / np.where(pos, cap, 1.0), 2.0)
        lat = p99_latency_ms_np(st.f["base_ms"][:sn], rho)
        req = np.where(active, lam * dt, 0.0)
        ok = np.where(active & (lat <= target + 1e-9), req, 0.0)
        uq = utility_np(lat, target, st.f["soft_ms"][:sn],
                        st.f["floor"][:sn]) * req
        st.f["req"][:sn] += req
        st.f["ok"][:sn] += ok
        st.f["util"][:sn] += uq
        m = self.metrics
        m.slo_requests_total += float(req.sum())
        m.slo_requests_ok += float(ok.sum())
        m.service_utility_sum += float(uq.sum())

    # ----------------------------------------------------------- throughputs
    def _colocated_running(self, tid: int) -> List[int]:
        """Workloads of other RUNNING tasks resident on tid's instance."""
        ts = self.tasks[tid]
        if ts.state != RUNNING or ts.src is None:
            return []
        inst = self.instances[ts.src]
        out = []
        for other in inst.residents:
            if other == tid:
                continue
            if self.tasks[other].state == RUNNING:
                out.append(self.tasks[other].workload)
        return out

    def _task_tput(self, tid: int) -> float:
        ts = self.tasks[tid]
        if ts.state != RUNNING:
            return 0.0
        t = 1.0
        for w2 in self._colocated_running(tid):
            t *= self._m[ts.workload, w2]
        if self._credits and self.instances[ts.src].throttled:
            t *= self._credit_models[
                self.instances[ts.src].type_index].baseline_fraction
        return t

    # ------------------------------------------------------------- credits
    def _instance_duty(self, inst: _Instance) -> float:
        """Busy intensity of an instance: the largest burst duty cycle among
        its RUNNING resident tasks (0 when nothing runs)."""
        duty = 0.0
        for tid in inst.residents:
            if self.tasks[tid].state == RUNNING:
                d = WORKLOADS[self.tasks[tid].workload].burst_duty
                if d > duty:
                    duty = d
        return duty

    def _credit_integrate(self, inst: _Instance, dt: float) -> None:
        """Advance an instance's credit balance by ``dt`` seconds of the
        *current* (pre-event) duty.  Throttled instances stay pinned at
        zero: the accrual is consumed by the baseline itself."""
        cm = self._credit_models[inst.type_index]
        if cm is None or inst._throttled:
            return
        net = cm.accrual_per_hour - self._instance_duty(inst)  # per hour
        inst._credit = min(cm.credit_cap_hours,
                           max(0.0, inst._credit + net * dt / 3600.0))

    def _credit_reproject(self, inst: _Instance) -> None:
        """Recompute throttle state and (re)project the deterministic
        exhaustion event after any change to the instance's RUNNING set."""
        cm = self._credit_models[inst.type_index]
        if cm is None or not inst.alive:
            return
        inst.credit_seq += 1  # invalidate any in-flight projection
        duty = self._instance_duty(inst)
        drain = cm.drain_per_hour(duty)
        if self._vec and inst._ct is not None:
            # refresh the cached net accrual rate the vectorized sweep
            # integrates with; duty only changes when the RUNNING-resident
            # set changes, and every such change lands here
            inst._ct.f["net"][inst._ct.slot[inst.iid]] = \
                cm.accrual_per_hour - duty
        if duty <= 0.0 or drain <= 0.0:
            inst.throttled = False  # idle or sustainable duty: (re)accruing
            return
        if inst.credit_hours <= 1e-9:
            inst.credit_hours = 0.0
            if not inst.throttled:
                inst.throttled = True
                self._on_credit_exhausted(inst)
            return
        inst.throttled = False
        eta = self.now + inst.credit_hours / drain * 3600.0
        self._push(eta, CREDIT_EXHAUST, (inst.iid, inst.credit_seq))

    def _pressure_signal(self, kind: str, ids: Sequence[int]) -> None:
        """Shared forced-reaction wiring for every scheduler-visible
        pressure event — spot revocation notices, credit exhaustion and
        deferral latest-start deadlines: publish one ``PressureSignal`` on
        the bus (delivered to the scheduler exactly once), then fire an
        immediate extra round — unless one is already queued at this
        instant, so coincident signals (e.g. two deferral deadlines at the
        same latest-start time) react in a single round instead of
        double-firing the forced partial."""
        if self._ev is not None:
            self._ev.emit(self.now, obs_ev.PRESSURE, signal=kind,
                          ids=tuple(ids))
        self.pressure_bus.publish(PressureSignal(kind, tuple(ids), self.now))
        if (self._round_scheduled_at != self.now
                and self._pressure_round_at != self.now):
            self._pressure_round_at = self.now
            self._push(self.now, ROUND, ())

    def _on_credit_exhausted(self, inst: _Instance) -> None:
        """An instance just throttled: surface the credit-pressure signal."""
        self.metrics.credit_exhaustions += 1
        if self._ev is not None:
            self._ev.emit(self.now, obs_ev.CREDIT_THROTTLE,
                          instance_id=inst.iid)
        self._pressure_signal(CREDIT, [inst.iid])

    def _on_credit_exhaust_event(self, iid: int, seq: int) -> None:
        inst = self.instances.get(iid)
        if inst is None or not inst.alive or inst.credit_seq != seq:
            return  # stale projection
        self._touch_instance_jobs(iid)  # reprojects credits + job rates

    def _job_rate(self, jid: int) -> float:
        js = self.jobs[jid]
        rate = math.inf
        for task in js.job.tasks:
            rate = min(rate, self._task_tput(task.task_id))
        return 0.0 if not math.isfinite(rate) else rate

    def _touch_job(self, jid: int):
        """Recompute a job's rate and (re)project its completion event."""
        js = self.jobs.get(jid)
        if js is None or not js.arrived or js.done_t is not None:
            return
        if js.job.service is not None:
            # service jobs end at a fixed wall-clock instant (pushed at
            # arrival), never by progress projection
            self._touch_service(js)
            return
        js.rate = self._job_rate(jid)
        js.version += 1
        if js.rate > 0:
            remaining = js.job.total_iters - js.iters_done
            eta = self.now + max(remaining, 0.0) / js.rate
            self._push(eta, JOB_DONE, (jid, js.version))

    def _svc_rate(self, js: _JobState, t: float) -> float:
        """Request rate at ``t`` via the job's monotone segment cursor over
        the profile's precomputed breakpoint arrays (cached at __init__) —
        O(1) amortized instead of a binary search per call.  Callers only
        move forward in time, matching the simulator clock; values are the
        exact floats ``RequestProfile.rate_at`` would return."""
        times = js.svc_times
        seg = js.svc_seg
        n = len(times)
        while seg + 1 < n and times[seg + 1] <= t:
            seg += 1
        js.svc_seg = seg
        return js.svc_rps[seg] if seg >= 0 else 0.0

    def _touch_service(self, js: _JobState) -> None:
        """Recompute a service job's effective capacity and utility-risk
        state.  SLO pressure fires on the *rising edge* of risk — load
        within the risk margin of the SLO-feasible utilization ceiling, or
        capacity short of load — through the shared pressure wiring."""
        spec = js.job.service
        cap = 0.0
        for task in js.job.tasks:
            cap += self._task_tput(task.task_id)
        cap *= spec.per_replica_rps
        js.svc_capacity = cap
        # normalized fleet capacity stands in for the batch rate, so the
        # shared running/idle/tput accounting stays meaningful for services
        js.rate = cap / max(spec.per_replica_rps * js.job.n_tasks, 1e-9)
        lam = self._svc_rate(js, self.now)
        js.svc_lam = lam  # the segment rate _svc_accrue integrates with
        risk = spec.at_risk(lam, cap)
        if risk and not js.svc_risk:
            js.svc_risk = True
            self.metrics.slo_pressure_signals += 1
            if self._ev is not None:
                self._ev.emit(self.now, obs_ev.SLO_RISK,
                              job_id=js.job.job_id, edge="on",
                              load_rps=lam, capacity_rps=cap)
            self._pressure_signal(SLO, (js.job.job_id,))
        elif not risk:
            if self._ev is not None and js.svc_risk:
                self._ev.emit(self.now, obs_ev.SLO_RISK,
                              job_id=js.job.job_id, edge="off",
                              load_rps=lam, capacity_rps=cap)
            js.svc_risk = False

    def _touch_instance_jobs(self, iid: int):
        inst = self.instances.get(iid)
        if inst is None:
            return
        if self._credits and inst.alive:
            # throttle state first: job rates below depend on it
            self._credit_reproject(inst)
        jids = {self.tasks[t].job_id for t in inst.residents | inst.assigned}
        for j in jids:
            self._touch_job(j)

    # -------------------------------------------------------------- executor
    def _region_has_capacity(self, k: int) -> bool:
        """May a fresh instance of type k launch, or is its region at its
        ``max_instances`` cap?  Counts every alive instance (incl. draining:
        they still bill and occupy regional quota)."""
        if self._regions is None:
            return True
        r = int(self._region_ids[k])
        cap = self._region_limits[r]  # mutable: commitment re-sizes grow it
        if cap is None:
            return True
        return self._region_alive[r] < cap

    def _launch_or_deny(self, k: int) -> Optional[_Instance]:
        if self._region_has_capacity(k):
            return self._new_instance(k)
        self.metrics.capacity_denied += 1
        if self._ev is not None:  # denials only happen on capped regions
            self._ev.emit(self.now, obs_ev.CAPACITY_DENIED,
                          type=self.catalog.types[k].name,
                          region=self._region_name_of_type[k])
        return None  # slot unfilled: its tasks stay put / pending

    def _new_instance(self, k: int) -> _Instance:
        iid = next(self._iid)
        acq = float(np.clip(6.0 + self.rng.exponential(13.0), 6.0, 83.0))
        setup = float(self.rng.uniform(140.0, 251.0))
        inst = _Instance(iid, k, self.now, self.now + acq + setup)
        if self._credits:
            cm = self._credit_models[k]
            if cm is not None:
                inst.credit_hours = cm.effective_launch_hours
                if self._vec:
                    # fresh instance idles (duty 0) until its first launch,
                    # so the cached net rate starts at the full accrual
                    self._ctab.add(iid, bal=inst._credit,
                                   net=cm.accrual_per_hour,
                                   cap_h=cm.credit_cap_hours)
                    inst._ct = self._ctab
        self.instances[iid] = inst
        self._alive[iid] = inst
        if self._vec:
            self._type_alive[k] += 1
        if self._regions is not None:
            self._region_alive[int(self._region_ids[k])] += 1
        self.metrics.instances_launched += 1
        if self._ev is not None:
            kw = {"type": self.catalog.types[k].name,
                  "ready_t": inst.ready_t}
            if self._regions is not None:
                kw["region"] = self._region_name_of_type[k]
            self._ev.emit(self.now, obs_ev.PROVISION, instance_id=iid, **kw)
        self._push(inst.ready_t, INSTANCE_READY, (iid,))
        if self.cfg.failure_mtbf_hours > 0:
            dt = self.rng.exponential(self.cfg.failure_mtbf_hours * 3600.0)
            self._push(self.now + dt, FAILURE, (iid,))
        return inst

    def _terminate(self, inst: _Instance, reason: str = "released"):
        if not inst.alive:
            return
        inst.terminated_t = self.now
        self._alive.pop(inst.iid, None)
        if self._vec:
            self._type_alive[inst.type_index] -= 1
            # terminate does not clear `assigned` (drain bookkeeping still
            # reads it), so subtract the snapshot from the fleet totals here
            self._assigned_total -= len(inst.assigned)
            self._alloc_total -= inst.alloc
            if inst._ct is not None:
                fin = inst._ct.remove(inst.iid)
                inst._ct = None
                inst._credit = fin["bal"]
                inst._throttled = fin["throttled"]
        if self._regions is not None:
            self._region_alive[int(self._region_ids[inst.type_index])] -= 1
        billed = 0.0
        pool = self._commit and self._pool_type[inst.type_index]
        # pool slots bill the standing rate (never per instance); spot
        # billing is integrated in _accrue instead
        if not pool and not self._spot:
            billed = ((self.now - inst.request_t) / 3600.0
                      * self.catalog.costs[inst.type_index])
            self._bill_type(billed, inst.type_index)
        if self._ev is not None:
            self._ev.emit(self.now, obs_ev.TERMINATE, instance_id=inst.iid,
                          reason=reason,
                          lifetime_s=self.now - inst.request_t,
                          billed=billed)

    def _maybe_finish_drain(self, inst: _Instance):
        if inst.draining and inst.alive and not inst.residents and not inst.assigned:
            self._terminate(inst, "drained")

    def _start_launch(self, tid: int):
        """Task is checkpointed (or fresh) and assigned; launch when dst ready."""
        ts = self.tasks[tid]
        inst = self.instances[ts.dst]
        if not inst.alive:  # dst died meanwhile
            self._make_pending(tid)
            return
        if inst.ready:
            ts.state = LAUNCH
            w = WORKLOADS[ts.workload]
            delay = (w.launch_delay_s * self.cfg.migration_delay_scale
                     + ts.restore_transfer_s)
            ts.restore_transfer_s = 0.0
            self._push(self.now + delay, LAUNCH_DONE, (tid, ts.epoch))
        else:
            ts.state = WAITING

    def _cross_region_charge(self, workload: int, r_s: int, r_d: int) -> float:
        """Extra checkpoint-transfer delay for moving a checkpoint from
        region ``r_s`` to ``r_d`` (live migration *or* a restore after a
        reclaim); also bills the egress fee — exactly once per move, to the
        source region.  Returns 0 for intra-region moves."""
        if r_s == r_d:
            return 0.0
        gb = checkpoint_size_gb(workload)
        fee = self.catalog.transfer.egress_usd(r_s, r_d, gb)
        self._bill_region(fee, r_s, obs_ev.COST_EGRESS)
        self.metrics.egress_cost += fee
        self.metrics.cross_region_migrations += 1
        if self._ev is not None:
            self._ev.emit(self.now, obs_ev.EGRESS,
                          src=self._regions[r_s].name,
                          dst=self._regions[r_d].name, gb=gb, fee=fee)
        return (self.catalog.transfer.transfer_time_s(r_s, r_d, gb)
                * self.cfg.migration_delay_scale)

    def _make_pending(self, tid: int):
        ts = self.tasks[tid]
        ts.state = PENDING
        ts.src = None
        ts.dst = None
        ts.epoch += 1
        ts.restore_transfer_s = 0.0  # ckpt_region keeps the durable copy

    def _execute_config(self, config: ClusterConfig):
        if self._deferrals:
            self._withdraw_deferred(config)
        live = self._live_instances()
        live_view = [LiveInstance(i.iid, i.type_index, tuple(sorted(i.assigned)))
                     for i in live]
        plan = diff_configs(live_view, config)

        # map plan slots to concrete instances (reuse matched, launch fresh).
        # A revoked (spot notice) or throttled (exhausted credits) instance
        # may only be reused by a slot that keeps some of its current tasks
        # (a non-aware scheduler rides it out); a zero-overlap match would
        # land brand-new tasks on a doomed/baseline-pinned instance, so it
        # launches fresh instead — a fresh burstable instance comes with
        # launch credits, not someone's exhausted balance.
        slot_inst: Dict[int, Optional[_Instance]] = {}
        for slot, (k, tids, matched) in enumerate(plan.slots):
            if matched is not None:
                minst = self.instances[matched]
                doomed = ((self._spot and minst.preempt_deadline is not None)
                          or (self._credits and minst.throttled))
                if doomed and not (set(tids) & minst.assigned):
                    slot_inst[slot] = self._launch_or_deny(k)
                else:
                    slot_inst[slot] = minst
            else:
                slot_inst[slot] = self._launch_or_deny(k)

        # Migrations.  Tasks mid-flight (WAITING/CKPT/LAUNCH) are pinned: the
        # executor defers moving them until they are RUNNING again.
        for mig in plan.migrations:
            ts = self.tasks[mig.task_id]
            dst = slot_inst[mig.dst_slot]
            if dst is None:
                continue  # launch denied (region at capacity): task stays put
            if ts.state in (WAITING, CKPT, LAUNCH):
                continue  # pinned
            if ts.dst == dst.iid:
                continue  # no-op
            if ts.state == RUNNING:
                # leave src: checkpoint first
                src = self.instances[ts.src]
                self._unassign_task(src, mig.task_id)
                ts.epoch += 1
                ts.state = CKPT
                ts.dst = dst.iid
                self._assign_task(dst, mig.task_id)
                w = WORKLOADS[ts.workload]
                delay = w.checkpoint_delay_s * self.cfg.migration_delay_scale
                if self._regions is not None:
                    r_d = int(self._region_ids[dst.type_index])
                    delay += self._cross_region_charge(
                        ts.workload, int(self._region_ids[src.type_index]),
                        r_d)
                    ts.ckpt_region = r_d  # checkpoint lands at the destination
                self._push(self.now + delay, CKPT_DONE, (mig.task_id, ts.epoch))
                ts.migrations += 1
                self.metrics.migrations += 1
                if self._ev is not None:
                    self._ev.emit(self.now, obs_ev.MIGRATE,
                                  instance_id=dst.iid, job_id=ts.job_id,
                                  task_id=mig.task_id, src=src.iid,
                                  delay_s=delay)
                self._touch_instance_jobs(src.iid)
            else:  # PENDING -> fresh placement
                ts.epoch += 1
                ts.dst = dst.iid
                self._assign_task(dst, mig.task_id)
                if self._ev is not None:
                    self._ev.emit(self.now, obs_ev.PLACE,
                                  instance_id=dst.iid, job_id=ts.job_id,
                                  task_id=mig.task_id)
                if self._deferrals:  # PENDING -> ADMIT transition
                    js = self.jobs[ts.job_id]
                    if js.admitted_t is None:
                        js.admitted_t = self.now
                        if self._ev is not None:
                            self._ev.emit(
                                self.now, obs_ev.ADMIT, job_id=ts.job_id,
                                wait_s=self.now - js.job.arrival_time)
                if ts.placed_once:
                    ts.migrations += 1
                    self.metrics.migrations += 1
                ts.placed_once = True
                # restoring a checkpoint stranded in another region (e.g.
                # after a reclaim) pays the same transfer + egress as a live
                # cross-region migration
                if self._regions is not None and ts.ckpt_region is not None:
                    r_d = int(self._region_ids[dst.type_index])
                    ts.restore_transfer_s = self._cross_region_charge(
                        ts.workload, ts.ckpt_region, r_d)
                    ts.ckpt_region = r_d
                self._start_launch(mig.task_id)

        # Terminations: instances not matched by any slot.
        for iid in plan.terminations:
            inst = self.instances[iid]
            if inst.assigned:
                continue  # defensive: scheduler kept tasks here implicitly
            if inst.residents:
                inst.draining = True
            else:
                self._terminate(inst, "evicted")

        # Evacuated revoked instances stop billing as soon as they are empty
        # (terminate during the notice window) instead of idling to reclaim.
        if self._spot:
            for inst in list(self._alive.values()):
                if (inst.alive and inst.preempt_deadline is not None
                        and not inst.assigned and not inst.draining):
                    inst.draining = True
                    self._maybe_finish_drain(inst)

    # ----------------------------------------------------------- monitoring
    def _report_throughputs(self):
        for jid, js in self._active_jobs.items():
            tasks = js.job.tasks
            if self._serving and js.job.service is not None:
                # replicas serve independently, so each running replica is
                # its own single-task interference observation rather than
                # the data-parallel min over the fleet
                for t in tasks:
                    ts = self.tasks[t.task_id]
                    if ts.state != RUNNING:
                        continue
                    if self._credits and self.instances[ts.src].throttled:
                        continue  # throttle-confounded: withhold
                    colo = self._colocated_running(t.task_id)
                    if colo:
                        self.scheduler.observe_single(
                            ts.workload, tuple(sorted(colo)),
                            self._task_tput(t.task_id))
                continue
            states = [self.tasks[t.task_id] for t in tasks]
            if any(s.state != RUNNING for s in states):
                continue
            if self._credits and any(self.instances[s.src].throttled
                                     for s in states):
                # throttle-confounded sample: the observed slowdown is the
                # credit baseline, not co-location interference — withhold
                # it from the monitor (credit state is cloud-visible)
                continue
            placements = []
            tputs = []
            for t in tasks:
                colo = self._colocated_running(t.task_id)
                placements.append((self.tasks[t.task_id].workload,
                                   tuple(sorted(colo))))
                tputs.append(self._task_tput(t.task_id))
            value = min(tputs)
            if len(tasks) == 1:
                w, colo = placements[0]
                if colo:
                    self.scheduler.observe_single(w, colo, value)
            else:
                self.scheduler.observe_job(placements, value)

    # ------------------------------------------------------------ round
    def _live_task_ids(self) -> List[int]:
        out = []
        for js in self._active_jobs.values():
            out.extend(t.task_id for t in js.job.tasks)
        return sorted(out)

    def _run_round(self):
        self._report_throughputs()
        tids = self._live_task_ids()
        if not tids:
            # nothing to schedule; terminate any empty instances
            for inst in self._live_instances():
                if not inst.assigned and not inst.residents:
                    self._terminate(inst, "idle")
            return
        taskset = TaskSet([self.tasks[t].task for t in tids])
        pending = {t for t in tids if self.tasks[t].dst is None}
        live_view = [LiveInstance(i.iid, i.type_index, tuple(sorted(i.assigned)))
                     for i in self._live_instances()]
        remaining = {}
        if self.scheduler.needs_runtime_estimates:
            for t in tids:
                js = self.jobs[self.tasks[t].job_id]
                remaining[t] = max(js.job.total_iters - js.iters_done, 0.0)
        revoked = {i.iid for i in self._live_instances()
                   if i.preempt_deadline is not None}
        ckpt_region = None
        if self._regions is not None:
            ckpt_region = {t: self.tasks[t].ckpt_region for t in tids
                           if self.tasks[t].ckpt_region is not None}
        instance_credits = None
        throttled = None
        if self._credits:
            instance_credits, throttled = {}, set()
            for i in self._live_instances():
                if self._credit_models[i.type_index] is not None:
                    instance_credits[i.iid] = i.credit_hours
                    if i.throttled:
                        throttled.add(i.iid)
        deferrable = deadline = pending_jobs = None
        if self._deferrals:
            jids = {self.tasks[t].job_id for t in tids}
            deferrable = {j for j in jids if self.jobs[j].job.deferrable}
            deadline = {j: float(self.jobs[j].job.deadline_s) for j in jids
                        if self.jobs[j].job.deadline_s is not None}
            pending_jobs = {j for j in jids if self._job_pending(j)}
            # queue-stability accounting: deferrable jobs whose tasks no
            # config has admitted yet (the pending queue a stability-aware
            # policy bounds)
            queued = sum(1 for j in deferrable
                         if self.jobs[j].admitted_t is None)
            if queued > self.metrics.max_pending_jobs:
                self.metrics.max_pending_jobs = queued
        service = service_rps = service_cap = slo_risk = specs = None
        if self._serving:
            service, service_rps, service_cap = set(), {}, {}
            slo_risk, specs = set(), {}
            for jid, js in self._active_jobs.items():
                spec = js.job.service
                if spec is None:
                    continue
                service.add(jid)
                service_rps[jid] = self._svc_rate(js, self.now)
                service_cap[jid] = js.svc_capacity
                specs[jid] = spec
                if js.svc_risk:
                    slo_risk.add(jid)
        view = SchedulerView(
            time=self.now, tasks=taskset, pending_ids=pending, live=live_view,
            task_workload={t: self.tasks[t].workload for t in tids},
            remaining_s=remaining or None, revoked=revoked or None,
            task_ckpt_region=ckpt_region or None,
            instance_credits=instance_credits or None,
            throttled=throttled or None, deferrable=deferrable or None,
            deadline_s=deadline or None, pending=pending_jobs or None,
            service=service or None, service_rps=service_rps or None,
            service_capacity=service_cap or None, slo_risk=slo_risk or None,
            service_specs=specs or None)
        config = self.scheduler.schedule(view)
        if self._rec is not None:
            self._emit_round(len(tids), len(pending))
        self._round_index += 1
        if self._commit:
            self._apply_commitment_orders()
        self._execute_config(config)

    def _emit_round(self, n_tasks: int, n_pending: int) -> None:
        """ROUND event + the per-round gauge samples (flight recorder on)."""
        self._ev.emit(self.now, obs_ev.ROUND, round_index=self._round_index,
                      n_tasks=n_tasks, n_pending=n_pending,
                      n_instances=len(self._alive))
        reg = self._rec.metrics
        t, m = self.now, self.metrics
        reg.inc("rounds")
        reg.sample("cost_total", t, m.total_cost)
        reg.sample("instances_alive", t, len(self._alive))
        reg.sample("tasks_live", t, n_tasks)
        reg.sample("tasks_pending", t, n_pending)
        if m.has_regions:
            for name, v in m.cost_by_region.items():
                reg.sample(f"cost_region:{name}", t, v)
        if m.has_service:
            reg.sample("slo_risk_jobs", t, sum(
                1 for js in self._active_jobs.values() if js.svc_risk))

    def _apply_commitment_orders(self) -> None:
        """Poll the scheduler for commitment re-sizes (the inventory
        decision, polled like ``admission``) and grow pools monotonically:
        commitments can be bought mid-run but never un-bought, so orders
        below the current pool size are ignored."""
        orders = getattr(self.scheduler, "commitment_orders", None)
        if not orders:
            return
        for name, size in orders.items():
            try:
                ri = self.catalog.region_index(name)
            except KeyError:
                continue
            if self._regions[ri].commitment is None:
                continue
            size = int(size)
            if size > self._pool_size[ri]:
                if self._ev is not None:
                    self._ev.emit(self.now, obs_ev.POOL_RESIZE, region=name,
                                  old=self._pool_size[ri], new=size)
                self._pool_size[ri] = size
                self._region_limits[ri] = size
                self.metrics.commitment_resizes += 1

    def _schedule_next_round(self):
        interval = self.cfg.round_interval_s
        nxt = math.floor(self.now / interval + 1.0) * interval
        if nxt > self._round_scheduled_at:
            self._round_scheduled_at = nxt
            self._push(nxt, ROUND, ())

    # ------------------------------------------------------------- handlers
    def _on_arrival(self, job: Job):
        js = _JobState(job=job, arrived=True)
        self.jobs[job.job_id] = js
        self._active_jobs[job.job_id] = js
        if self._vec:
            self._jtab.add(job.job_id)
            js._jt = self._jtab
        if self._ev is not None:
            self._ev.emit(self.now, obs_ev.JOB_ARRIVE, job_id=job.job_id,
                          n_tasks=job.n_tasks)
        for t in job.tasks:
            self.tasks[t.task_id] = _TaskState(task=t, job_id=job.job_id,
                                               workload=t.workload)
        if self._serving and job.service is not None:
            spec = job.service
            js.svc_times, js.svc_rps = self._profile_segs[id(spec.requests)]
            if self._vec:
                u = spec.utility
                self._stab.add(job.job_id, base_ms=spec.base_latency_ms,
                               target_ms=u.target_p99_ms,
                               soft_ms=u.softness_ms, floor=u.floor)
                js._st = self._stab
            # fixed wall-clock serving window: the end event is pushed once
            # at arrival (version -1 marks it as the non-projected end), and
            # the initial risk check fires SLO pressure immediately if load
            # is already nonzero — latency traffic cannot wait for the next
            # grid round
            self._push(self.now + job.duration_s, JOB_DONE, (job.job_id, -1))
            self._touch_service(js)
        self.scheduler.on_event(self.now)
        self._schedule_next_round()

    def _on_instance_ready(self, iid: int):
        inst = self.instances.get(iid)
        if inst is None or not inst.alive:
            return
        inst.ready = True
        if self._ev is not None:
            self._ev.emit(self.now, obs_ev.READY, instance_id=iid,
                          acquisition_s=self.now - inst.request_t)
        for tid in sorted(inst.assigned):
            if self.tasks[tid].state == WAITING:
                self._start_launch(tid)

    def _on_ckpt_done(self, tid: int, epoch: int):
        ts = self.tasks[tid]
        if ts.epoch != epoch or ts.state != CKPT:
            return
        if ts.src is not None:
            src = self.instances[ts.src]
            src.residents.discard(tid)
            self._touch_instance_jobs(src.iid)
            self._maybe_finish_drain(src)
        ts.src = None
        self._start_launch(tid)

    def _on_launch_done(self, tid: int, epoch: int):
        ts = self.tasks[tid]
        if ts.epoch != epoch or ts.state != LAUNCH:
            return
        inst = self.instances[ts.dst]
        ts.state = RUNNING
        ts.src = inst.iid
        if self._regions is not None:  # checkpoints now written here
            ts.ckpt_region = int(self._region_ids[inst.type_index])
        inst.residents.add(tid)
        self._touch_instance_jobs(inst.iid)

    def _on_job_done(self, jid: int, version: int):
        js = self.jobs[jid]
        if js.done_t is not None:
            return
        if js.job.service is not None:
            if version != -1:
                return  # progress projections never complete a service job
        else:
            if js.version != version:
                return
            if js.iters_done < js.job.total_iters - 1e-6:
                return  # stale projection
        js.done_t = self.now
        js.job.completion_time = self.now
        if self._vec:
            # deregister from the SoA tables; remove() hands back the final
            # column values, which become the plain attributes every later
            # reader (metric folds below, summaries, tests) sees
            fin = self._jtab.remove(jid)
            js._jt = None
            js._iters = fin["iters"]
            js._idle = fin["idle"]
            js._run_s = fin["run_s"]
            js._tputw = fin["tputw"]
            js._rate = fin["rate"]
            if js._st is not None:
                sfin = self._stab.remove(jid)
                js._st = None
                js._req = sfin["req"]
                js._ok = sfin["ok"]
                js._util = sfin["util"]
                js._svc_lam = sfin["lam"]
                js._svc_cap = sfin["cap"]
        if self._ev is not None:
            self._ev.emit(self.now, obs_ev.JOB_DONE, job_id=jid,
                          jct_s=self.now - js.job.arrival_time)
        self._active_jobs.pop(jid, None)
        self._jobs_outstanding -= 1
        if self._deferrals:
            if (js.job.deadline_s is not None
                    and self.now > js.job.deadline_s):
                self.metrics.deadline_misses += 1
            if js.job.deferrable and js.admitted_t is not None:
                wait = max(js.admitted_t - js.job.arrival_time, 0.0)
                self.metrics.deferred_wait_s += wait
                if wait > self.cfg.round_interval_s:  # held past round 1
                    self.metrics.deferred_jobs += 1
        if (self._spot or self._credits or self._deferrals or self._serving) \
                and self._jobs_outstanding == 0:
            # drop remaining one-shot breakpoint / credit-exhaustion /
            # latest-start / rate-update events (a long price trace or a
            # far-out projection would otherwise no-op through the heap and
            # inflate end_time)
            self._heap = [e for e in self._heap
                          if e[1] not in (PRICE_UPDATE, CREDIT_EXHAUST,
                                          DEFER_DEADLINE, RATE_UPDATE)]
            heapq.heapify(self._heap)
        self.metrics.jct_sum += self.now - js.job.arrival_time
        self.metrics.idle_sum += js.idle_s
        self.metrics.running_sum += js.running_s
        self.metrics.tput_weighted_sum += js.tput_weighted
        for t in js.job.tasks:
            ts = self.tasks[t.task_id]
            for ref in (ts.src, ts.dst):
                if ref is not None and ref in self.instances:
                    inst = self.instances[ref]
                    self._unassign_task(inst, t.task_id)
                    inst.residents.discard(t.task_id)
                    self._touch_instance_jobs(inst.iid)
                    self._maybe_finish_drain(inst)
            ts.state = PENDING
            ts.src = ts.dst = None
            ts.epoch += 1
        # housekeeping: empty instances release immediately (applies equally
        # to all schedulers; non-empty ones wait for the next round)
        for inst in self._live_instances():
            if not inst.assigned and not inst.residents:
                self._terminate(inst, "idle")
        self.scheduler.on_event(self.now)

    def _kill_instance(self, inst: _Instance, rng, reason: str):
        """Reclaim an instance out from under its tasks (failure or spot
        preemption): victims lose up to one checkpoint period of progress and
        re-enter PENDING."""
        iid = inst.iid
        victims = set(inst.assigned) | set(inst.residents)
        self._terminate(inst, reason)
        jids = set()
        for tid in victims:
            ts = self.tasks[tid]
            jids.add(ts.job_id)
            # progress loss up to one checkpoint period
            js = self.jobs[ts.job_id]
            loss = js.rate * rng.uniform(0, self.cfg.checkpoint_period_s)
            js.iters_done = max(0.0, js.iters_done - loss)
            # clear any other reservation
            if ts.dst is not None and ts.dst in self.instances and ts.dst != iid:
                self._unassign_task(self.instances[ts.dst], tid)
            self._make_pending(tid)
        for j in jids:
            self._touch_job(j)
        self._schedule_next_round()

    def _on_failure(self, iid: int):
        inst = self.instances.get(iid)
        if inst is None or not inst.alive:
            return
        self.metrics.failures += 1
        if self._ev is not None:
            self._ev.emit(self.now, obs_ev.FAILURE, instance_id=iid,
                          victims=len(inst.assigned | inst.residents))
        self._kill_instance(inst, self.rng, "failure")

    # --------------------------------------------------------- spot handlers
    def _on_price_update(self, periodic: bool = True):
        pm = self.catalog.price_model
        # segment price vector for [now, next update): same floats at(now)
        # would yield, without materializing a catalog snapshot per update
        self._cur_costs = self.catalog.prices_between(
            self.now, self.now + self._price_interval)
        dt = self.now - self._last_price_update  # actual elapsed exposure
        self._last_price_update = self.now
        noticed: List[int] = []
        if self.cfg.preemption_hazard_per_hour > 0 and dt > 0:
            pressure = pm.pressure_at(len(self.catalog), self.now)
            for iid in sorted(self._alive):
                inst = self._alive[iid]
                if inst.preempt_deadline is not None:
                    continue
                lam = (self.cfg.preemption_hazard_per_hour / 3600.0
                       * float(pressure[inst.type_index]))
                if self._spot_rng.uniform() < 1.0 - math.exp(-lam * dt):
                    inst.preempt_deadline = self.now + self.cfg.preemption_notice_s
                    self.metrics.preemption_notices += 1
                    self._push(inst.preempt_deadline, PREEMPT_FIRE, (iid,))
                    noticed.append(iid)
                    if self._ev is not None:
                        self._ev.emit(self.now, obs_ev.NOTICE,
                                      instance_id=iid,
                                      deadline=inst.preempt_deadline)
        if noticed:
            # immediate reaction so the scheduler can evacuate within the
            # notice window
            self._pressure_signal(SPOT, noticed)
        # only the periodic chain self-perpetuates; breakpoint events are
        # one-shots scheduled up-front
        if periodic and self._jobs_outstanding > 0:
            self._push(self.now + self._price_interval, PRICE_UPDATE, (True,))

    def _on_preempt_fire(self, iid: int):
        inst = self.instances.get(iid)
        if inst is None or not inst.alive:
            return  # evacuated and terminated before the deadline
        self.metrics.preemptions += 1
        if self._ev is not None:
            self._ev.emit(self.now, obs_ev.PREEMPT, instance_id=iid,
                          victims=len(inst.assigned | inst.residents))
        self._kill_instance(inst, self._spot_rng, "preempt")

    # ----------------------------------------------------- deferral handlers
    def _job_pending(self, jid: int) -> bool:
        """No task of the job has started (running or mid-launch): the job
        is still in the pending state — cheap to defer or re-defer."""
        return all(self.tasks[t.task_id].state in (PENDING, WAITING)
                   for t in self.jobs[jid].job.tasks)

    def _on_defer_deadline(self, jid: int):
        """A deferrable job's latest-start time arrived.  If the scheduler
        is still holding it, signal deadline pressure (callback + immediate
        extra round — the shared pressure wiring) so it can be admitted in
        this very instant rather than up to a round interval late."""
        js = self.jobs.get(jid)
        if js is None or not js.arrived or js.done_t is not None:
            return
        if not self._job_pending(jid):
            return  # already admitted and under way
        if self._ev is not None:
            self._ev.emit(self.now, obs_ev.DEFER_DEADLINE, job_id=jid)
        self._pressure_signal(DEADLINE, [jid])

    # ------------------------------------------------------ serving handlers
    def _on_rate_update(self, jid: int) -> None:
        """A service job's request rate just stepped to a new level
        (profile breakpoint): re-evaluate utility risk against the already
        up-to-date capacity (the accrual up to this instant used the old
        rate)."""
        js = self.jobs.get(jid)
        if js is None or not js.arrived or js.done_t is not None:
            return
        self._touch_service(js)

    def _withdraw_deferred(self, config: ClusterConfig) -> None:
        """Release reserved-but-unstarted placements of re-deferred jobs:
        the config omits their tasks, so any WAITING task (assigned to an
        instance that is still acquiring / not yet launched on) of a
        deferrable job returns to PENDING and its slot reservation is
        dropped before the plan diff — the vacated instance then terminates
        or is re-matched like any other.  Tasks that are launching, running
        or checkpointing are never withdrawn."""
        cfg_tids = {t for _, tids in config.assignments for t in tids}
        for inst in self._live_instances():
            for tid in sorted(inst.assigned):
                ts = self.tasks[tid]
                if (tid in cfg_tids or ts.state != WAITING
                        or not self.jobs[ts.job_id].job.deferrable):
                    continue
                self._unassign_task(inst, tid)
                self._make_pending(tid)
                self.metrics.withdrawals += 1
                if self._ev is not None:
                    self._ev.emit(self.now, obs_ev.WITHDRAW,
                                  instance_id=inst.iid, job_id=ts.job_id,
                                  task_id=tid)
                if self._job_pending(ts.job_id):
                    self.jobs[ts.job_id].admitted_t = None  # back to PENDING

    # ----------------------------------------------------------------- main
    def _dispatch(self, kind: int, payload: tuple) -> None:
        if kind == ARRIVAL:
            self._on_arrival(*payload)
        elif kind == INSTANCE_READY:
            self._on_instance_ready(*payload)
        elif kind == CKPT_DONE:
            self._on_ckpt_done(*payload)
        elif kind == LAUNCH_DONE:
            self._on_launch_done(*payload)
        elif kind == JOB_DONE:
            self._on_job_done(*payload)
        elif kind == FAILURE:
            self._on_failure(*payload)
        elif kind == PRICE_UPDATE:
            self._on_price_update(*payload)
        elif kind == PREEMPT_FIRE:
            self._on_preempt_fire(*payload)
        elif kind == CREDIT_EXHAUST:
            self._on_credit_exhaust_event(*payload)
        elif kind == DEFER_DEADLINE:
            self._on_defer_deadline(*payload)
        elif kind == RATE_UPDATE:
            self._on_rate_update(*payload)
        elif kind == ROUND:
            self._run_round()
            if self._live_task_ids():
                self._schedule_next_round()

    def run(self) -> Metrics:
        while self._heap:
            t, kind, _, payload = heapq.heappop(self._heap)
            if t > self.cfg.max_time_s:
                break
            self._accrue(t)
            self.now = t
            self._dispatch(kind, payload)
            if kind in _COALESCE:
                # Coincident bursts of the same kind (RATE_UPDATE fan-outs
                # over a shared profile grid, simultaneous arrival waves,
                # periodic + breakpoint price updates) run under a single
                # accrual sweep.  Safe because these handlers only push
                # same-timestamp events of later-sorting kinds (ROUND) or
                # strictly-future events, so batch order equals pop order —
                # and the dt<=0 re-accrual between them was already a no-op.
                # Reference self._heap afresh each pop: handlers may rebind
                # it (none of the coalesced kinds do, but stay defensive).
                while (self._heap and self._heap[0][0] == t
                       and self._heap[0][1] == kind):
                    self._dispatch(kind, heapq.heappop(self._heap)[3])
        # drain any leftover instances at the end
        for inst in list(self._alive.values()):
            self._terminate(inst, "end_of_run")
        if self._commit:  # finalize the pool ledgers
            for ri, _cm in self._pools:
                cap_s = self._pool_capacity_s[ri]
                cov_s = self._pool_covered_s[ri]
                self.metrics.commitment_utilization[
                    self._regions[ri].name] = \
                    cov_s / cap_s if cap_s > 0.0 else 0.0
                self.metrics.commitment_idle_cost += \
                    (cap_s - cov_s) / 3600.0 * self._pool_rate[ri]
        if self._deferrals:  # deadlines blown by never finishing count too
            for js in self.jobs.values():
                if (js.done_t is None and js.job.deadline_s is not None
                        and self.now > js.job.deadline_s):
                    self.metrics.deadline_misses += 1
        self.metrics.end_time = self.now
        return self.metrics
