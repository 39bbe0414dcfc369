"""SLO-aware serving policy: provision and *hold* capacity headroom for
latency jobs in Eva's reservation-price market.

Batch tasks are priced by what completion is worth; an inference replica is
priced by what *latency* is worth — its value evaporates the moment the
fleet saturates mid-surge, and the S·D̂ > ΔM evict test knows nothing about
that.  ``SLOLayer`` closes the gap purely on the PolicyLayer hook points
(no scheduler-core edits, like ``StabilityLayer`` before it):

* **standing headroom** (``pre_round``): every service task's CPU/RAM
  demand is inflated by ``headroom`` in the *planning view only* (billing
  and execution use true demands).  Replicas get room from the moment they
  are packed — fewer interfering co-tenants per box, so effective serving
  capacity stays near the undegraded fleet rate.  The GPU coordinate is
  left exact (it is the integral packing key).
* **warm-keep exemption** (``keep_bonus``): an instance hosting a replica
  of an at-utility-risk job gets an effectively infinite keep slack —
  exempt from the S·D̂ > ΔM evict test until the risk clears.  Off-risk,
  replica hosts keep a standing slack equal to the replicas' relaunch
  overhead amortized over D̂ (a replica in flight is serving capacity
  lost for minutes, which is exactly what the relaunch penalty prices).
* **risk-damped repacking** (``plan_catalog``): the layer keeps an EMA of
  the planning price vector; while any service job is at utility risk,
  prices *below* their EMA are lifted toward it (dips damped, rises
  untouched) so the ensemble does not chase a transient spot dip with
  replica migrations mid-surge.  Identity when no job is at risk.
* **capacity-aware move veto** (``refine``): the S·D̂ > ΔM criterion
  prices a replica migration at its checkpoint-and-relaunch overhead, but
  a replica in flight is also *serving capacity offline* — a term ΔM
  cannot see (and Full Reconfiguration never consults the keep test at
  all, so a price dip can put every replica in flight at once).  The
  post-pass re-diffs the adopted config and admits replica moves one at a
  time only while the surviving in-place capacity still clears the job's
  utility-risk margin at the *current* request rate; vetoed replicas are
  restored to their live instances.  At the diurnal trough most of the
  fleet may chase cheaper types (staggered, never all at once); at the
  surge peak nothing moves.

Utility risk arrives two ways, both deterministic: the per-round
``view.slo_risk`` set, and rising-edge ``slo`` pressure signals
(``on_pressure`` + the simulator's immediate extra round), so the layer
reacts the instant a surge or a capacity loss puts the SLO in danger —
the pre-warming idea of predictive autoscalers (arXiv 2010.05049) keyed
off the risk margin instead of a learned forecast.

Hook-for-hook the identity on views without service jobs, so stacks that
include ``SLOLayer`` are bit-identical to stacks that do not on pure batch
traces (pinned in ``tests/test_policies.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Set

import numpy as np

from ..core.cluster_types import ClusterConfig, TaskSet
from ..core.plan import diff_configs
from .base import PLANNING, PolicyLayer
from .layers import relaunch_penalty
from .pressure import SLO, PressureSignal

# keep slack handed to instances hosting at-risk replicas: large enough to
# defeat any hourly price gap (the dearest type is ~$25/h), finite so the
# summed slack stays a well-behaved float
EXEMPT_SLACK = 1e9


class SLOLayer(PolicyLayer):
    """Serving-aware headroom provisioning and warm-keep, written purely
    against the policy-stack hooks (``pre_round`` / ``keep_bonus`` /
    ``plan_catalog`` / ``on_pressure``)."""

    name = "slo"
    catalog_phase = PLANNING

    def __init__(self, *, headroom: float = 1.3, hold: float = 1.0,
                 damp: float = 1.0, ema_alpha: float = 0.2):
        assert headroom >= 1.0 and hold >= 0.0 and 0.0 <= damp <= 1.0
        self.headroom = float(headroom)
        self.hold = float(hold)
        self.damp = float(damp)
        self.ema_alpha = float(ema_alpha)
        self._risk: Set[int] = set()  # service jobs currently at utility risk
        self._service: Set[int] = set()  # live service jobs this round
        self._ema: Optional[np.ndarray] = None  # planning-price EMA
        self.slo_signals = 0  # risk rising edges signalled to us
        self.risk_rounds = 0  # rounds planned with some job at risk
        self.move_vetoes = 0  # replica moves reverted by the capacity veto

    # ------------------------------------------------------------ pre_round
    def pre_round(self, view, d_hat_s):
        if not view.service:
            self._risk = set()
            self._service = set()
            return view, set()
        self._service = set(view.service)
        # signals that raced ahead of the view are already folded in: the
        # simulator latches risk before publishing, so view.slo_risk is the
        # authoritative per-round set
        self._risk = set(view.slo_risk or ()) & self._service
        if self._risk:
            self.risk_rounds += 1
        if self.headroom > 1.0:
            view = self._inflate_service_demand(view)
        return view, set()

    def _inflate_service_demand(self, view):
        """Standing headroom: service tasks plan with CPU/RAM inflated by
        ``headroom`` so Algorithm 1 leaves them co-tenant room.  View-only —
        the executor and biller always use true demands."""
        ts = view.tasks
        rows = np.isin(ts.job_ids, np.fromiter(self._service, dtype=np.int64))
        if not rows.any():
            return view
        d = ts.demand_by_family.copy()
        d[rows, :, 1:] *= self.headroom  # (gpu, cpu, ram): gpu stays exact
        # drop the Task-object list: a subset() downstream would otherwise
        # rebuild from true demands and silently lose the inflation
        inflated = TaskSet.from_arrays(ts.ids, ts.job_ids, ts.workloads, d)
        return dataclasses.replace(view, tasks=inflated)

    # --------------------------------------------------------- plan_catalog
    def plan_catalog(self, catalog, view, d_hat_s):
        costs = np.asarray(catalog.costs, dtype=np.float64)
        if self._ema is None or self._ema.shape != costs.shape:
            self._ema = costs.copy()
        else:
            a = self.ema_alpha
            self._ema = a * costs + (1.0 - a) * self._ema
        if not self._risk or self.damp <= 0.0:
            return catalog
        # dips damped toward the running average while utility is at risk;
        # price rises pass through untouched (they still justify keeps via
        # the exemption, not via stale cheap prices)
        lifted = costs + self.damp * (self._ema - costs)
        damped = np.where(costs < self._ema, lifted, costs)
        order = np.argsort(-damped, kind="stable")
        return dataclasses.replace(catalog, costs=damped, order_desc=order)

    # ----------------------------------------------------------- keep_bonus
    def keep_bonus(self, raw, cat, view):
        if not self._service:
            return None
        service, risk, hold = self._service, self._risk, self.hold
        jid_of = dict(zip(view.tasks.ids.tolist(),
                          view.tasks.job_ids.tolist()))
        sched = self.sched
        d_hr = max(sched.estimator.d_hat() / 3600.0, 1e-9)
        task_workload = view.task_workload
        scale = sched.migration_delay_scale

        def slo_bonus(k: int, tids) -> float:
            svc = [t for t in tids if jid_of.get(t) in service]
            if not svc:
                return 0.0
            if any(jid_of[t] in risk for t in svc):
                return EXEMPT_SLACK  # warm host: exempt while at risk
            if hold <= 0.0:
                return 0.0
            # off-risk: hold the host at the replicas' relaunch overhead —
            # migrating a replica is minutes of lost serving capacity
            return hold * relaunch_penalty(cat, k, k, svc, task_workload,
                                           scale) / d_hr

        return slo_bonus

    # --------------------------------------------------------------- refine
    def refine(self, config, view, cat):
        """Capacity-aware replica-move veto (see module docstring).

        Re-diffs the adopted config against the live fleet and walks each
        service job's replica moves in deterministic (task id) order,
        admitting one only while the job stays clear of utility risk with
        that many replicas in flight — each in-flight replica is charged
        its per-replica share of the job's *current* (interference-
        degraded) capacity.  Vetoed replicas go back into the slot their
        live instance was matched to (or a restored slot for it), so the
        executor keeps the instance and no migration happens.  Moves off
        revoked or throttled hosts are never vetoed: those raise capacity.
        """
        if not self._service or view.service_specs is None:
            return config
        plan = diff_configs(view.live, config)
        jid_of = dict(zip(view.tasks.ids.tolist(),
                          view.tasks.job_ids.tolist()))
        doomed = set(view.revoked or ()) | set(view.throttled or ())
        moved: dict = {}  # jid -> [(tid, src iid)], replica moves to judge
        for m in plan.migrations:
            if m.src_instance is None or m.src_instance in doomed:
                continue  # fresh launch or escape from a dying host
            jid = jid_of.get(m.task_id)
            if jid in self._service:
                moved.setdefault(jid, []).append((m.task_id, m.src_instance))
        if not moved:
            return config
        live_by_id = {i.instance_id: i for i in view.live}
        # live replica count per service job (tasks physically on instances)
        n_live = {jid: 0 for jid in moved}
        for inst in view.live:
            for t in inst.task_ids:
                j = jid_of.get(t)
                if j in n_live:
                    n_live[j] += 1
        vetoed: dict = {}  # src iid -> [tids to restore there]
        for jid, mv in sorted(moved.items()):
            spec = view.service_specs.get(jid)
            n = n_live.get(jid, 0)
            if spec is None or n == 0:
                continue
            lam = (view.service_rps or {}).get(jid, 0.0)
            cap = (view.service_capacity or {}).get(jid, 0.0)
            in_flight = 0
            for tid, src in sorted(mv):
                survive = cap * (n - in_flight - 1) / n
                if spec.at_risk(lam, survive):
                    vetoed.setdefault(src, []).append(tid)
                else:
                    in_flight += 1
        if not vetoed:
            return config
        self.move_vetoes += sum(len(ts) for ts in vetoed.values())
        assignments = [(k, list(tids)) for k, tids, _ in plan.slots]
        slot_of_iid = {iid: s for s, (_, _, iid) in enumerate(plan.slots)
                       if iid is not None}
        revert = {t for ts in vetoed.values() for t in ts}
        for _, tids in assignments:
            tids[:] = [t for t in tids if t not in revert]
        for src, tids in sorted(vetoed.items()):
            inst = live_by_id[src]
            s = slot_of_iid.get(src)
            if s is not None and assignments[s][0] == inst.type_index:
                assignments[s][1].extend(tids)
            else:
                assignments.append((inst.type_index, tids))
        return ClusterConfig([(k, tuple(tids)) for k, tids in assignments
                              if tids])

    # ----------------------------------------------------------- on_pressure
    def on_pressure(self, signal: PressureSignal) -> None:
        if signal.kind == SLO:
            self.slo_signals += len(signal.ids)
            # react in the forced round the signal triggers, before the
            # next view refresh
            self._risk |= set(signal.ids)

    def summary(self) -> dict:
        return {"slo_signals": self.slo_signals,
                "risk_rounds": self.risk_rounds,
                "move_vetoes": self.move_vetoes}
