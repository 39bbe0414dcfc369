"""Scheduler interface + the Eva scheduler (ensemble of Full/Partial, §4.5).

Public API (docs/ARCHITECTURE.md diagrams the round-by-round data flow):

* ``SchedulerView`` — the per-round snapshot a scheduler sees: live tasks,
  pending ids, live placements, (spot scenarios) revocation notices,
  (burstable scenarios) per-instance credit balances + throttled set, and
  (deferral scenarios) deferrable job ids, per-job deadlines and the
  still-pending job set.
* ``SchedulerBase`` — ``schedule(view) -> ClusterConfig`` plus the monitor
  hooks (``on_event``, ``on_pressure`` — which fans out to the legacy
  per-kind hooks ``on_preemption_notice`` / ``on_credit_pressure`` /
  ``on_deadline_pressure`` — and ``observe_single/job``).
* ``EvaScheduler`` — the paper's ensemble of Full and Partial
  Reconfiguration over TNRP, with the ablation knobs
  (``interference_aware``, ``multi_task_aware``, ``mode``).  Beyond-paper
  scenario axes compose as a **policy stack** (``repro.policies``): pass
  ``policies=[SpotLayer(), MultiRegionLayer(), CreditLayer(),
  AutoscaleLayer(strike=0.9)]`` (any subset, in the documented order) and
  the scheduler folds their hooks — catalog snapshot transforms, admission
  edits, keep-test slack, pack masks/budgets, forced evacuations and
  config refinements — around the unchanged Algorithm-1 ensemble.  The
  legacy boolean kwargs (``spot_aware`` / ``multi_region`` /
  ``credit_aware`` / ``autoscale`` + ``region=`` / ``strike=`` /
  ``admission=``) remain as a deprecation shim that builds the equivalent
  stack, bit-identical by test.
* ``NoPackingScheduler`` — one task per reservation-price instance (§6.1).

The simulator (and the local-cloud physical harness) call ``schedule(view)``
each scheduling round and execute the returned abstract configuration via
``core.plan.diff_configs``.  Throughput observations flow back through
``observe_*`` callbacks, arrival/completion events through ``on_event``,
and pressure signals (spot revocations, credit exhaustion, deferral
deadlines) through one ``PressureBus`` (``repro.policies.pressure``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Set

from ..obs.trace import DecisionRecord, KeepEntry
from .catalog import Catalog
from .cluster_types import ClusterConfig, TaskSet
from .ensemble import EnsembleDecision, EventRateEstimator, choose, instantaneous_saving
from .full_reconfig import EPS, evaluate_assignments, full_reconfiguration
from .partial_reconfig import (incremental_reconfiguration,
                               partial_reconfiguration)
from .plan import LiveInstance, diff_configs, migration_cost
from .reservation_price import cheapest_type, reservation_prices
from .throughput_table import ThroughputTable
from .workloads import NUM_WORKLOADS


@dataclasses.dataclass
class SchedulerView:
    """Snapshot handed to a scheduler at each round."""
    time: float
    tasks: TaskSet  # all live tasks (placed + pending)
    pending_ids: Set[int]
    live: List[LiveInstance]
    task_workload: Dict[int, int]
    # runtime estimates (iters remaining / standalone rate), only for
    # schedulers that declare needs_runtime_estimates (Stratus best-case).
    remaining_s: Optional[Dict[int, float]] = None
    # live instance ids under a spot revocation notice (reclaim imminent);
    # None outside spot scenarios.
    revoked: Optional[Set[int]] = None
    # task id -> region index of its durable checkpoint (multi-region only;
    # lets migration_cost price a cross-region restore of a reclaimed task)
    task_ckpt_region: Optional[Dict[int, int]] = None
    # burstable scenarios only: live burstable instance id -> credit balance
    # (full-speed hours), and the subset currently throttled to baseline.
    instance_credits: Optional[Dict[int, float]] = None
    throttled: Optional[Set[int]] = None
    # deferral scenarios only (some job deferrable or deadlined; None
    # otherwise): job ids marked deferrable, job id -> absolute completion
    # deadline, and the jobs still *pending* — no task running or mid-launch,
    # so holding (or re-deferring) them costs nothing but time.
    deferrable: Optional[Set[int]] = None
    deadline_s: Optional[Dict[int, float]] = None
    pending: Optional[Set[int]] = None
    # serving scenarios only (some job carries a ServiceSpec; None
    # otherwise): live service job ids, job id -> current request rate
    # (rps), job id -> current effective serving capacity (rps at observed
    # replica throughput), and the subset at utility risk — utilization
    # within the risk margin of the job's SLO-feasible ceiling, or capacity
    # short of load entirely.
    service: Optional[Set[int]] = None
    service_rps: Optional[Dict[int, float]] = None
    service_capacity: Optional[Dict[int, float]] = None
    slo_risk: Optional[Set[int]] = None
    # job id -> its ServiceSpec (latency model + utility curve), so serving
    # layers can evaluate `at_risk` against hypothetical capacities
    service_specs: Optional[Dict[int, object]] = None


class SchedulerBase:
    name = "base"
    needs_runtime_estimates = False
    needs_true_profile = False

    def __init__(self, catalog: Catalog):
        self.catalog = catalog

    # -- monitor hooks ------------------------------------------------------
    def on_event(self, time_s: float) -> None:  # job arrival/completion
        pass

    def on_pressure(self, signal) -> None:
        """One ``repro.policies.pressure.PressureSignal`` per pressure
        event.  The base implementation fans out to the legacy per-kind
        hooks so flag-era subclasses (and the baselines) keep working."""
        if signal.kind == "spot":
            self.on_preemption_notice(signal.ids, signal.time)
        elif signal.kind == "credit":
            self.on_credit_pressure(signal.ids, signal.time)
        elif signal.kind == "deadline":
            self.on_deadline_pressure(signal.ids, signal.time)
        elif signal.kind == "slo":
            self.on_slo_pressure(signal.ids, signal.time)

    def on_preemption_notice(self, instance_ids: Sequence[int],
                             time_s: float) -> None:  # spot revocation notice
        pass

    def on_credit_pressure(self, instance_ids: Sequence[int],
                           time_s: float) -> None:  # credits just exhausted
        pass

    def on_deadline_pressure(self, job_ids: Sequence[int],
                             time_s: float) -> None:  # latest start reached
        pass

    def on_slo_pressure(self, job_ids: Sequence[int],
                        time_s: float) -> None:  # service utility at risk
        pass

    def observe_single(self, workload: int, colocated: Sequence[int],
                       value: float) -> None:
        pass

    def observe_job(self, placements, value: float) -> None:
        pass

    # -- main entry ---------------------------------------------------------
    def schedule(self, view: SchedulerView) -> ClusterConfig:
        raise NotImplementedError


class EvaScheduler(SchedulerBase):
    """Eva (§4): ensemble of Full and Partial Reconfiguration over TNRP.

    Variants used in the paper's ablations:
      * interference_aware=False  -> Eva-RP  (Fig. 4)
      * multi_task_aware=False    -> Eva-Single (Table 6 / Fig. 7)
      * mode="full-only" / "partial-only"  (Fig. 5b / Fig. 6)

    Beyond the paper, scenario axes attach as a **policy stack**
    (``repro.policies``): the scheduler itself is Algorithm 1 + the
    ensemble criterion, and every axis-specific behaviour — spot
    re-pricing and revocation evacuation (``SpotLayer``), multi-region
    capacity budgets / keep slack / arbitrage (``MultiRegionLayer``),
    credit-aware planning and drains (``CreditLayer``), admission control
    (``AutoscaleLayer``, ``StabilityLayer``) — enters through the stack's
    hook points:

    * ``pre_round``      — admission layers strip held jobs' tasks from
      the round's view before anything is priced;
    * ``plan``           — the catalog pipeline (snapshot transforms, then
      planning transforms: ``at → credit_priced``) yields the round's
      billing-accurate ``raw`` and planning ``cat`` catalogs;
    * ``keep_bonus``     — summed per-instance keep-test slack;
    * ``mask`` / ``caps``— standing type restrictions and per-region pack
      budgets threaded into RP / Full / Partial;
    * ``evacuate`` + ``drain_mask`` — pressure reactions, answered by one
      shared forced partial reconfiguration;
    * ``refine``         — post-pass config rewrites (region arbitrage).

    The legacy boolean kwargs (``spot_aware=True`` etc.) are a
    deprecation shim: they emit a ``DeprecationWarning`` and build the
    equivalent stack via ``repro.policies.stack_from_flags``, with
    decisions bit-identical to the flag-era scheduler
    (``tests/test_policies.py`` pins this on every bundled demo catalog).
    """

    name = "eva"

    def __init__(self, catalog: Catalog, *, interference_aware: bool = True,
                 multi_task_aware: bool = True, mode: str = "ensemble",
                 default_t: float = 0.95, engine: str = "numpy",
                 migration_delay_scale: float = 1.0,
                 incremental: bool = False,
                 policies: Optional[object] = None,
                 spot_aware: bool = False, multi_region: bool = False,
                 credit_aware: bool = False, autoscale: bool = False,
                 admission: Optional[object] = None, strike: float = 1.0,
                 region: Optional[str] = None, recorder=None):
        super().__init__(catalog)
        # flight recorder (repro.obs.FlightRecorder): pure observer — every
        # trace path below is gated on self._rec, and the decision trace is
        # assembled from the same inputs the decision used (re-running only
        # pure evaluation helpers), so decisions are unchanged when on
        self._rec = recorder
        self._trace_pending: Optional[DecisionRecord] = None
        self._trace_parts: List = []
        assert mode in ("ensemble", "full-only", "partial-only")
        self.interference_aware = interference_aware
        self.multi_task_aware = multi_task_aware
        self.mode = mode
        self.engine = engine
        self.migration_delay_scale = migration_delay_scale
        # deferred import: repro.policies imports core submodules
        from ..policies import PolicyStack, stack_from_flags
        flags_used = spot_aware or multi_region or credit_aware or autoscale
        legacy_used = (flags_used or region is not None
                       or admission is not None or strike != 1.0)
        if policies is not None and legacy_used:
            raise ValueError(
                "pass either policies=[...] or the legacy flag kwargs "
                "(spot_aware/multi_region/credit_aware/autoscale/region/"
                "admission/strike), not both")
        if legacy_used:
            if flags_used:
                warnings.warn(
                    "EvaScheduler's boolean scenario flags (spot_aware/"
                    "multi_region/credit_aware/autoscale) are deprecated; "
                    "pass the equivalent policy stack, e.g. "
                    "policies=[SpotLayer(), ...] (repro.policies)",
                    DeprecationWarning, stacklevel=2)
            policies = stack_from_flags(
                spot_aware=spot_aware, multi_region=multi_region,
                credit_aware=credit_aware, autoscale=autoscale,
                region=region, admission=admission, strike=strike)
        if policies is None:
            policies = PolicyStack()
        elif not isinstance(policies, PolicyStack):
            policies = PolicyStack(policies)
        self.stack = policies
        self.stack.bind(self)
        self.needs_runtime_estimates = self.stack.needs_runtime_estimates
        self.forced_partials = 0
        # incremental repack: buffer the round's pressure signals so the
        # forced partial can re-plan only the instances they touched
        self.incremental = incremental
        self._pressure_buffer: List[object] = []
        self.incremental_rounds = 0
        self.incremental_fallbacks = 0
        self.table = ThroughputTable(NUM_WORKLOADS, default=default_t)
        self.estimator = EventRateEstimator()
        self.decisions: List[EnsembleDecision] = []
        self.full_adoptions = 0
        self.rounds = 0

    # -- legacy introspection (flag-era attribute surface) -------------------
    @property
    def spot_aware(self) -> bool:
        return self.stack.has("spot")

    @property
    def multi_region(self) -> bool:
        return self.stack.has("multi-region")

    @property
    def credit_aware(self) -> bool:
        return self.stack.has("credit")

    @property
    def autoscale(self) -> bool:
        return self.stack.has("autoscale")

    @property
    def admission(self) -> Optional[object]:
        """Controller of the first admission layer (autoscale/stability),
        if any — the simulator reads its margin/overhead for the
        DEFER_DEADLINE backstop."""
        from ..policies import AdmissionLayerBase
        layer = self.stack.get(AdmissionLayerBase)
        return None if layer is None else layer.controller

    @property
    def commitment_orders(self) -> Optional[Dict[str, int]]:
        """Pool-region-name -> desired pool size from portfolio layers —
        the inventory channel the simulator polls after each round (like
        ``admission``), applied monotonically (pools grow, never shrink)."""
        out: Dict[str, int] = {}
        for la in self.stack:
            orders = getattr(la, "commitment_orders", None)
            if orders:
                out.update(orders)
        return out or None

    @property
    def arbitrage_moves(self) -> int:
        return sum(getattr(la, "arbitrage_moves", 0) for la in self.stack)

    @property
    def credit_signals(self) -> int:
        return sum(getattr(la, "credit_signals", 0) for la in self.stack)

    @property
    def credit_drains(self) -> int:
        return sum(getattr(la, "credit_drains", 0) for la in self.stack)

    @property
    def deadline_signals(self) -> int:
        return sum(getattr(la, "deadline_signals", 0) for la in self.stack)

    # -- monitor ------------------------------------------------------------
    def on_event(self, time_s: float) -> None:
        self.estimator.on_event(time_s)

    def on_pressure(self, signal) -> None:
        super().on_pressure(signal)  # legacy per-kind hooks (subclasses)
        self.stack.on_pressure(signal)
        if self.incremental:
            self._pressure_buffer.append(signal)

    def observe_single(self, workload, colocated, value) -> None:
        if self.interference_aware:
            self.table.observe_single(workload, colocated, value)

    def observe_job(self, placements, value) -> None:
        if self.interference_aware:
            self.table.observe_job(placements, value)

    # -- scheduling ---------------------------------------------------------
    def schedule(self, view: SchedulerView) -> ClusterConfig:
        self.rounds += 1
        table = self.table if self.interference_aware else None
        kw = dict(interference_aware=self.interference_aware,
                  multi_task_aware=self.multi_task_aware, engine=self.engine)
        d_hat = self.estimator.d_hat()
        # Admission layers first: jobs a controller holds are removed from
        # the round's task set before anything is priced, so Algorithm 1
        # never provisions for them.
        view, resumed = self.stack.pre_round(view, d_hat)
        # Catalog pipeline: snapshot transforms (spot re-pricing at the
        # current time), then planning transforms (credit-effective
        # $/throughput) — `raw` bills, `cat` plans.
        raw, cat = self.stack.plan(self.catalog, view, d_hat)
        if self._rec is None:
            keep_bonus = self.stack.keep_bonus(raw, cat, view)
        else:
            # identical fold, but keep the per-layer parts so the decision
            # trace can decompose the summed slack by contributing layer
            # (each layer's hook still runs exactly once)
            self._trace_parts = self.stack.keep_bonus_parts(raw, cat, view)
            keep_bonus = self.stack.combine(
                fn for _, fn in self._trace_parts)
            self._trace_pending = self._trace_begin(view, cat, d_hat)
        mask, caps = self.stack.mask, self.stack.caps

        evac = self.stack.evacuate(raw, view)
        if evac or resumed:
            if self._trace_pending is not None:
                self._trace_pending.kind = "forced-partial"
                self._trace_pending.evacuated = tuple(sorted(evac))
                self._trace_pending.resumed_jobs = tuple(sorted(resumed))
            return self._forced_partial(view, raw, cat, table, kw,
                                        keep_bonus, evac)
        self._pressure_buffer.clear()  # nothing forced a reaction round

        live_assignments = [(i.type_index, i.task_ids) for i in view.live]
        if self._trace_pending is not None and self.mode != "full-only":
            self._trace_pending.keep_table = self._trace_keep_table(
                view.live, view.tasks, cat, table, mask)
        if self.mode == "full-only":
            cfg = full_reconfiguration(view.tasks, cat, table,
                                       type_mask=mask,
                                       region_caps=caps, **kw)
            self.full_adoptions += 1
            if self._trace_pending is not None:
                self._trace_pending.kind = "full-only"
            return self._finish(cfg, view, cat)
        partial = partial_reconfiguration(view.tasks, live_assignments,
                                          view.pending_ids, cat,
                                          table, type_mask=mask,
                                          region_caps=caps,
                                          keep_bonus=keep_bonus, **kw)
        if self.mode == "partial-only":
            if self._trace_pending is not None:
                self._trace_pending.kind = "partial-only"
            return self._finish(partial, view, cat)
        full = full_reconfiguration(view.tasks, cat, table,
                                    type_mask=mask,
                                    region_caps=caps, **kw)

        s_f = instantaneous_saving(*evaluate_assignments(
            full.assignments, view.tasks, cat, table,
            self.multi_task_aware, type_mask=mask))
        s_p = instantaneous_saving(*evaluate_assignments(
            partial.assignments, view.tasks, cat, table,
            self.multi_task_aware, type_mask=mask))
        m_f = migration_cost(diff_configs(view.live, full), view.live,
                             cat, view.task_workload,
                             self.migration_delay_scale,
                             task_ckpt_region=view.task_ckpt_region)
        m_p = migration_cost(diff_configs(view.live, partial), view.live,
                             cat, view.task_workload,
                             self.migration_delay_scale,
                             task_ckpt_region=view.task_ckpt_region)
        decision = choose(s_f, m_f, s_p, m_p, self.estimator.d_hat())
        self.decisions.append(decision)
        if self._trace_pending is not None:
            self._trace_pending.kind = "ensemble"
            self._trace_pending.s_full = float(s_f)
            self._trace_pending.m_full = float(m_f)
            self._trace_pending.s_partial = float(s_p)
            self._trace_pending.m_partial = float(m_p)
            self._trace_pending.adopt_full = bool(decision.adopt_full)
        if decision.adopt_full:
            self.full_adoptions += 1
            self.estimator.on_full_reconfig()
            return self._finish(full, view, cat)
        return self._finish(partial, view, cat)

    # -- pressure reactions (spot / credit / deferral), one shared path ------
    def _forced_partial(self, view: SchedulerView, raw: Catalog, cat: Catalog,
                        table, kw, keep_bonus,
                        evac: Set[int]) -> ClusterConfig:
        """Shared forced-partial wiring for every pressure signal: spot
        revocation notices *evacuate* the doomed instances, credit
        exhaustion *drains* throttled ones onto steady types, and a
        deferral resume (latest-start deadline) *places* the force-admitted
        job's tasks — all via one partial reconfiguration whose repack set
        holds the triggering tasks.  Evacuated/drained instances are
        dropped from the live view so nothing is kept (or placed) on them;
        resumed jobs' tasks are already in ``pending_ids``.  The type mask
        is the stack's drain mask (standing mask AND any drain
        restrictions, e.g. steady-types-only for credit drains)."""
        mask = self.stack.drain_mask(raw, view)
        self.forced_partials += 1
        if self.incremental:
            from ..policies.pressure import dirty_instance_ids
            dirty = dirty_instance_ids(self._pressure_buffer) | evac
            self._pressure_buffer.clear()
            self.incremental_rounds += 1
            cfg, fallback = incremental_reconfiguration(
                view.tasks, view.live, dirty, view.pending_ids, cat, table,
                evacuate=evac, type_mask=mask, region_caps=self.stack.caps,
                keep_bonus=keep_bonus, **kw)
            if fallback is not None:
                self.incremental_fallbacks += 1
            if self._trace_pending is not None:
                self._trace_pending.dirty = tuple(sorted(dirty))
                self._trace_pending.incremental_fallback = fallback
            return self._finish(cfg, view, cat)
        live = [i for i in view.live if i.instance_id not in evac]
        pending = set(view.pending_ids)
        for inst in view.live:
            if inst.instance_id in evac:
                pending |= set(inst.task_ids)
        if self._trace_pending is not None:
            # the forced partial's keep test runs over the survivors under
            # the drain mask — record exactly that landscape
            self._trace_pending.keep_table = self._trace_keep_table(
                live, view.tasks, cat, table, mask)
        cfg = partial_reconfiguration(
            view.tasks, [(i.type_index, i.task_ids) for i in live],
            pending, cat, table, type_mask=mask,
            region_caps=self.stack.caps, keep_bonus=keep_bonus, **kw)
        return self._finish(cfg, view, cat)

    def _finish(self, config: ClusterConfig, view: SchedulerView,
                cat: Catalog) -> ClusterConfig:
        if self._rec is None:
            return self.stack.refine(config, view, cat)
        before = self._numeric_summary()
        config = self.stack.refine(config, view, cat)
        after = self._numeric_summary()
        trace = self._trace_pending
        if trace is not None:
            self._trace_pending = None
            trace.refine_deltas = {k: after[k] - before[k] for k in after
                                   if k in before and after[k] != before[k]}
            self._rec.decisions.append(trace)
        return config

    # -- decision trace (pure observers; recorder attached only) -------------
    def _numeric_summary(self) -> Dict[str, float]:
        return {k: v for k, v in self.stack.summary().items()
                if isinstance(v, (int, float)) and not isinstance(v, bool)}

    def _trace_begin(self, view: SchedulerView, cat: Catalog,
                     d_hat: float) -> DecisionRecord:
        n = len(view.tasks.ids)
        if n:
            rp = reservation_prices(view.tasks, cat,
                                    type_mask=self.stack.mask)
            rp_min, rp_mean, rp_max = (float(rp.min()), float(rp.mean()),
                                       float(rp.max()))
        else:
            rp_min = rp_mean = rp_max = 0.0
        return DecisionRecord(
            t=view.time, round_index=self.rounds - 1, kind="",
            d_hat_s=float(d_hat), n_tasks=n,
            n_pending=len(view.pending_ids), rp_min=rp_min, rp_mean=rp_mean,
            rp_max=rp_max, mask_layers=self.stack.mask_layers,
            caps_layer=self.stack.caps_layer)

    def _trace_keep_table(self, live: Sequence[LiveInstance], tasks: TaskSet,
                          cat: Catalog, table, mask) -> List[KeepEntry]:
        """Replay the partial keep test (same pure helpers, same inputs)
        with the summed ``keep_bonus`` decomposed by contributing layer."""
        system_ids = set(tasks.ids.tolist())
        trimmed, iids = [], []
        for inst in live:
            alive = tuple(t for t in inst.task_ids if t in system_ids)
            if alive:
                trimmed.append((inst.type_index, alive))
                iids.append(inst.instance_id)
        if not trimmed:
            return []
        tnrps, costs = evaluate_assignments(trimmed, tasks, cat, table,
                                            self.multi_task_aware,
                                            type_mask=mask)
        out: List[KeepEntry] = []
        for iid, (k, tids), s, c in zip(iids, trimmed, tnrps, costs):
            by_layer = {name: float(fn(k, tids))
                        for name, fn in self._trace_parts}
            bonus = sum(by_layer.values())
            out.append(KeepEntry(
                instance_id=iid, type_index=int(k), saving=float(s),
                cost=float(c), bonus=bonus,
                bonus_by_layer={n2: v for n2, v in by_layer.items()
                                if v != 0.0},
                kept=bool(s >= c - bonus - EPS)))
        return out

    @property
    def full_adoption_rate(self) -> float:
        return self.full_adoptions / max(self.rounds, 1)


class NoPackingScheduler(SchedulerBase):
    """One task per instance, each on its reservation-price type (§6.1)."""

    name = "no-packing"

    def schedule(self, view: SchedulerView) -> ClusterConfig:
        system_ids = set(view.tasks.ids.tolist())
        assignments = []
        for inst in view.live:
            alive = tuple(t for t in inst.task_ids if t in system_ids)
            if alive:
                assignments.append((inst.type_index, alive))
        placed = {t for _, tids in assignments for t in tids}
        todo = sorted(t for t in system_ids if t not in placed)
        if todo:
            sub = view.tasks.subset(todo)
            kinds = cheapest_type(sub, self.catalog)
            for tid, k in zip(todo, kinds.tolist()):
                assignments.append((int(k), (tid,)))
        return ClusterConfig(assignments)
