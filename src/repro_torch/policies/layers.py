"""The four existing scenario axes, ported onto the policy-layer protocol.

Each layer is the exact decision logic the corresponding ``EvaScheduler``
boolean flag used to interleave through ``core/scheduler.py`` — the
bit-identity tests in ``tests/test_policies.py`` pin flag-API and
stack-API decisions to each other on every bundled demo catalog.

* ``SpotLayer``       — re-price every round against ``catalog.at(t)`` and
                        evacuate instances under a revocation notice.
* ``RegionPinLayer``  — pin packing to one region of a multi-region
                        catalog (the single-market baseline).
* ``MultiRegionLayer``— capacity-aware packing budgets, the cross-region
                        keep-test slack, and the per-region-pair S·D̂ > ΔM
                        arbitrage refinement.
* ``CreditLayer``     — plan against ``credit_priced(D̂)``, decay the
                        keep-test slack with live balances, and drain
                        throttled instances onto steady types.
* ``AutoscaleLayer``  — forecast-driven admission control over deferrable
                        jobs (wraps ``repro.autoscale.AdmissionController``).

``repro.policies.stability.StabilityLayer`` — the first axis written
purely against these hooks — lives in its own module.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Set, Tuple

import numpy as np

from ..core.cluster_types import ClusterConfig
from ..core.plan import diff_configs, migration_cost, task_move_cost
from ..core.workloads import INSTANCE_ACQUISITION_S, INSTANCE_SETUP_S
from .base import PLANNING, SNAPSHOT, PolicyLayer
from .pressure import CREDIT, DEADLINE, PressureSignal


def relaunch_penalty(cat, k_src: int, k_dst: int, tids, task_workload,
                     delay_scale: float) -> float:
    """One-off $ cost of standing an instance's task set up elsewhere:
    fresh-instance acquisition + setup billed idle at the destination's
    price, plus each resident task's checkpoint + launch move cost
    (``k_src == k_dst`` prices a same-type relaunch).  Shared by the
    multi-region re-home slack and the stability warm-keep slack so the
    two keep tests can never diverge on relaunch-overhead pricing."""
    pen = ((INSTANCE_ACQUISITION_S + INSTANCE_SETUP_S) / 3600.0
           * cat.costs[k_dst])
    for t in tids:
        pen += task_move_cost(cat, task_workload[t], k_src, k_dst,
                              delay_scale)
    return pen


class SpotLayer(PolicyLayer):
    """Spot-market awareness: time-varying prices + revocation evacuation.

    ``plan_catalog`` snapshots the catalog at the round's time (the
    identity on static catalogs), and ``evacuate`` forces instances under
    an active revocation notice out of the config so their tasks re-enter
    the repack set within the notice window.
    """

    name = "spot"
    catalog_phase = SNAPSHOT

    def plan_catalog(self, catalog, view, d_hat_s):
        return catalog.at(view.time)

    def evacuate(self, raw, view) -> Set[int]:
        return set(view.revoked) if view.revoked else set()


class RegionPinLayer(PolicyLayer):
    """Pin packing to a single region of a multi-region catalog."""

    name = "region-pin"

    def __init__(self, region: str):
        self.region = region

    def bind(self, scheduler) -> None:
        super().bind(scheduler)
        assert scheduler.catalog.is_multi_region, \
            "a region pin needs a multi_region_catalog"

    def type_mask(self, catalog) -> Optional[np.ndarray]:
        return catalog.region_type_mask(catalog.region_index(self.region))


class MultiRegionLayer(RegionPinLayer):
    """Multi-region arbitrage: capacity budgets, cross-region keep slack,
    and the per-region-pair reconfiguration trade-off.

    ``region=`` optionally pins the layer to a single region (then only
    the capacity budgets and keep slack remain active — every arbitrage
    candidate outside the pin is masked out).
    """

    name = "multi-region"

    def __init__(self, region: Optional[str] = None):
        self.region = region
        self.arbitrage_moves = 0

    def bind(self, scheduler) -> None:
        PolicyLayer.bind(self, scheduler)
        assert scheduler.catalog.is_multi_region, \
            "MultiRegionLayer needs a multi_region_catalog"

    def type_mask(self, catalog) -> Optional[np.ndarray]:
        if self.region is None:
            return None
        return super().type_mask(catalog)

    def region_caps(self, catalog) -> Optional[tuple]:
        if any(r.max_instances is not None for r in catalog.regions):
            return tuple(r.max_instances for r in catalog.regions)
        return None

    def keep_bonus(self, raw, cat, view):
        """Amortized ($/h over D̂) cost of re-homing an instance's task set
        to the cheapest same-hardware region copy — relaunch idle time,
        per-task checkpoint+launch delay, checkpoint transfer time, and the
        egress fee.  Zero when the instance already sits in the cheapest
        region, so intra-region evictions are untouched.

        Known trade-off: the slack assumes an eviction from a dear region
        re-homes cross-region (true when the price gap is what made the set
        inefficient, since RP anchors to the cheapest region).  An instance
        that turned inefficient for other reasons (e.g. a completed sibling
        shrank the set) gets the same slack and may be held up to one D̂
        window before intra-region consolidation — bounded by the slack
        being the one-off move cost spread over D̂."""
        sched = self.sched
        mask = sched.stack.mask
        task_workload = view.task_workload
        d_hr = max(sched.estimator.d_hat() / 3600.0, 1e-9)

        def region_bonus(k: int, tids) -> float:
            k2 = cat.cheapest_copy(k, mask)
            if cat.region_of(k2) == cat.region_of(k):
                return 0.0
            return relaunch_penalty(cat, k, k2, tids, task_workload,
                                    sched.migration_delay_scale) / d_hr

        return region_bonus

    def refine(self, config, view, cat):
        """Per-region-pair reconfiguration trade-off (the paper's S·D̂ > M
        criterion applied to region moves): re-home each slot to the
        cheapest same-hardware copy in another region iff the hourly price
        saving, amortized over D̂ (the estimated time to the next Full
        Reconfiguration), exceeds the migration-cost *delta* of the
        rewrite — which prices the checkpoint transfer, egress fee, and
        fresh-instance launch via ``migration_cost`` on the diffed plans.
        Each adopted rewrite re-diffs the whole plan (exact, O(slots·live)
        per candidate — slot-local deltas would miss greedy-matching
        interactions between same-type slots); rounds here are tens of
        slots, so this is cheap.

        Capacity headroom is tracked against the *configuration being
        refined* (slots per region, updated as rewrites are adopted),
        since the config is what the executor will instantiate; the
        simulator's per-region denial remains the hard backstop."""
        if len(cat.regions) < 2:
            return config
        sched = self.sched
        mask = sched.stack.mask
        assignments = list(config.assignments)
        d_hr = sched.estimator.d_hat() / 3600.0
        caps = [r.max_instances for r in cat.regions]
        counts = np.zeros(len(cat.regions), dtype=np.int64)
        for k, _ in assignments:
            counts[cat.region_of(k)] += 1
        cur_m: Optional[float] = None
        changed = False
        for slot, (k, tids) in enumerate(assignments):
            base = int(cat.base_index[k])
            cand = cat.base_index == base
            if mask is not None:  # honour a region pin
                cand = cand & mask
            # cheapest same-hardware region copy with capacity headroom
            best_k = int(k)
            for k2 in np.nonzero(cand)[0].tolist():
                r2 = cat.region_of(k2)
                if (r2 != cat.region_of(k) and caps[r2] is not None
                        and counts[r2] >= caps[r2]):
                    continue
                if cat.costs[k2] < cat.costs[best_k] - 1e-12:
                    best_k = int(k2)
            if best_k == k:
                continue
            if cur_m is None:
                cur_m = migration_cost(
                    diff_configs(view.live, ClusterConfig(assignments)),
                    view.live, cat, view.task_workload,
                    sched.migration_delay_scale,
                    task_ckpt_region=view.task_ckpt_region)
            trial = list(assignments)
            trial[slot] = (best_k, tids)
            trial_m = migration_cost(
                diff_configs(view.live, ClusterConfig(trial)), view.live,
                cat, view.task_workload, sched.migration_delay_scale,
                task_ckpt_region=view.task_ckpt_region)
            saving = float(cat.costs[k] - cat.costs[best_k]) * d_hr
            if saving > trial_m - cur_m:
                assignments = trial
                cur_m = trial_m
                counts[cat.region_of(best_k)] += 1
                counts[cat.region_of(k)] -= 1  # slot vacated its old region
                self.arbitrage_moves += 1
                changed = True
        return ClusterConfig(assignments) if changed else config

    def summary(self) -> dict:
        return {"arbitrage_moves": self.arbitrage_moves}


class CreditLayer(PolicyLayer):
    """Burstable-credit awareness (CASH): effective $/throughput planning,
    balance-decayed keep slack, and throttled-instance drains.

    Inert (hook-for-hook the identity) on catalogs without burstable
    types, so spot / multi-region stacks that include it are bit-identical
    to stacks that do not.
    """

    name = "credit"
    catalog_phase = PLANNING

    def __init__(self):
        self.credit_signals = 0  # exhausted instances signalled to us
        self.credit_drains = 0  # forced partials that drained throttled insts

    def plan_catalog(self, catalog, view, d_hat_s):
        # effective $/throughput over the D̂ horizon (identity for
        # non-burstable catalogs) — billing still happens at the raw
        # prices; this is purely the planning view.
        if not catalog.is_burstable:
            return catalog
        return catalog.credit_priced(d_hat_s)

    def keep_bonus(self, raw, cat, view):
        """Planning cost of a *fresh* instance of the type (``cat.costs[k]``,
        launch-credit priced over D̂) minus the effective cost of *this*
        instance at its live balance.  ~0 while the balance matches a fresh
        launch, decaying below zero as credits drain; at exhaustion the
        keep test effectively demands TNRP ≥ cost/baseline_fraction, which
        collapses with the throughput and evicts the set into the repack."""
        if not raw.is_burstable or not view.instance_credits:
            return None
        balances = view.instance_credits
        task_iid = {t: i.instance_id for i in view.live
                    for t in i.task_ids}
        horizon_h = self.sched.estimator.d_hat() / 3600.0

        def credit_bonus(k: int, tids) -> float:
            cm = raw.credit_models[k]
            if cm is None or not tids:
                return 0.0
            bal = balances.get(task_iid.get(tids[0], -1))
            if bal is None:
                return 0.0
            eff = raw.costs[k] / cm.avg_speed_over(bal, horizon_h)
            return float(cat.costs[k] - eff)

        return credit_bonus

    def evacuate(self, raw, view) -> Set[int]:
        if raw.is_burstable and view.throttled:
            return set(view.throttled)
        return set()

    def drain_mask(self, raw, view) -> Optional[np.ndarray]:
        """Drain onto steady (non-burstable) types: an anonymous slot of
        the same burstable type would simply re-match the exhausted
        instance, so the escape must change type.  Fresh arrivals burst
        again in later (unmasked) rounds."""
        if not (raw.is_burstable and view.throttled):
            return None
        self.credit_drains += 1
        return np.array([cm is None for cm in raw.credit_models])

    def on_pressure(self, signal: PressureSignal) -> None:
        if signal.kind == CREDIT:
            self.credit_signals += len(signal.ids)

    def summary(self) -> dict:
        return {"credit_drains": self.credit_drains,
                "credit_signals": self.credit_signals}


class AdmissionLayerBase(PolicyLayer):
    """Shared plumbing for admission-control layers (autoscale,
    stability): wrap a controller with a ``review(view, d_hat) -> (held,
    forced)`` contract, strip held jobs' tasks from the round's view, and
    feed latest-start pressure signals back into the controller."""

    needs_runtime_estimates = True  # latest-start bounds need D̂_j

    def __init__(self, controller=None):
        self._controller = controller
        self.deadline_signals = 0  # latest-start deadlines signalled to us
        self.last_held: Set[int] = set()

    def _make_controller(self, catalog, type_mask):
        raise NotImplementedError

    def post_bind(self, stack) -> None:
        if self._controller is None:
            # a region pin restricts the strike test too: the controller
            # may only price a job against types the packer can use
            self._controller = self._make_controller(self.sched.catalog,
                                                     stack.mask)

    @property
    def controller(self):
        return self._controller

    def pre_round(self, view, d_hat_s) -> Tuple[object, Set[int]]:
        """Run the admission review and strip held jobs' tasks from the
        round's view, so Algorithm 1 never provisions for them.  Returns
        the (possibly filtered) view plus the jobs force-admitted by their
        latest-start bound this round."""
        if not view.deferrable:
            self.last_held = set()  # no live deferrable jobs: queue empty
            return view, set()
        held, resumed = self._controller.review(view, d_hat_s)
        self.last_held = held
        if held:
            ids = view.tasks.ids.tolist()
            jids = view.tasks.job_ids.tolist()
            held_t = {t for t, j in zip(ids, jids) if j in held}
            view = dataclasses.replace(
                view, tasks=view.tasks.subset(
                    [t for t in ids if t not in held_t]),
                pending_ids=set(view.pending_ids) - held_t)
        return view, resumed

    def on_pressure(self, signal: PressureSignal) -> None:
        if signal.kind == DEADLINE:
            self.deadline_signals += len(signal.ids)
            self._controller.note_deadline(signal.ids)

    def summary(self) -> dict:
        ctl = self._controller
        return {"admissions": ctl.admissions,
                "forced_admissions": ctl.forced_admissions,
                "re_deferrals": ctl.re_deferrals,
                "held_job_rounds": ctl.held_job_rounds}


class AutoscaleLayer(AdmissionLayerBase):
    """Price-pressure admission control over the job population: hold each
    deferrable not-yet-started job while the forecast effective
    $/throughput over its estimated duration sits above ``strike`` × its
    long-run-anchor reservation price, bounded by per-job latest-start
    deadlines (``repro.autoscale.AdmissionController``)."""

    name = "autoscale"

    def __init__(self, controller=None, *, strike: float = 1.0):
        super().__init__(controller)
        self.strike = float(strike)

    def _make_controller(self, catalog, type_mask):
        # deferred import: repro.autoscale itself imports core submodules
        from ..autoscale.admission import AdmissionController
        return AdmissionController(catalog, strike=self.strike,
                                   type_mask=type_mask)


def stack_from_flags(*, spot_aware: bool = False, multi_region: bool = False,
                     credit_aware: bool = False, autoscale: bool = False,
                     stability: bool = False, slo: bool = False,
                     portfolio: bool = False,
                     region: Optional[str] = None,
                     admission=None, strike: Optional[float] = None,
                     v: Optional[float] = None,
                     extra: Sequence[PolicyLayer] = ()):
    """Build the policy stack equivalent to the legacy boolean-flag API.

    This is both the ``EvaScheduler`` deprecation shim and the benchmark
    factory's translation layer; the bit-identity tests pin its output to
    the historical flag behaviour.  Note ``multi_region`` and
    ``credit_aware`` imply the spot behaviour (time-snapshot pricing +
    revocation evacuation), exactly as the flags did.
    """
    from .base import PolicyStack
    layers: list = []
    if spot_aware or multi_region or credit_aware:
        layers.append(SpotLayer())
    if multi_region:
        layers.append(MultiRegionLayer(region=region))
    elif region is not None:
        layers.append(RegionPinLayer(region))
    if credit_aware:
        layers.append(CreditLayer())
    if portfolio:
        from .portfolio import PortfolioLayer
        layers.append(PortfolioLayer())
    # strike / v fall back to each layer's own default when not given
    knobs = {k: val for k, val in (("strike", strike), ("v", v))
             if val is not None}
    if autoscale:
        kw = {k: v_ for k, v_ in knobs.items() if k == "strike"}
        layers.append(AutoscaleLayer(admission, **kw))
    if stability:
        from .stability import StabilityLayer
        layers.append(StabilityLayer(admission, **knobs))
    if slo:
        from .slo import SLOLayer
        layers.append(SLOLayer())
    layers.extend(extra)
    return PolicyStack(layers)
