"""Stability-vs-cost admission: drift-plus-penalty queue control.

The strike-chasing ``AutoscaleLayer`` holds every deferrable job while the
market sits above its strike — on a market that stays dear, the pending
queue grows without bound until latest-start deadlines force a burst of
simultaneous admissions.  ``StabilityLayer`` schedules for *queue
stability against server running cost* ("Scheduling Policies for Stability
and Optimal Server Running Cost in Cloud Computing Platforms",
arXiv 2201.09050): a Lyapunov drift-plus-penalty trade-off between
pending-queue growth and the price premium of running now.

Mechanics, all against the policy-stack hooks (this is the first layer
written purely on the new API — no scheduler-core edits):

* **drift-plus-penalty admission** (``StabilityController``): each held
  job accrues queue backlog ``q_j`` (rounds held, the per-job share of the
  controller's ``held_job_rounds`` drift term).  The job is admitted when
  the market is at or below its anchor (the strike test), **or** as soon
  as the backlog term outweighs the cost penalty of paying today's
  premium::

      q_j · rp_anchor  >  V · (rp_forecast − strike · rp_anchor)

  ``V`` is the patience dial (rounds of queueing tolerated per unit of
  relative price premium): ``V → ∞`` recovers pure strike-price chasing,
  ``V = 0`` admits after a single held round.  Because OU/trace market
  premiums are bounded (spot is capped at on-demand), every job's backlog
  eventually dominates — queue length is bounded without ever touching
  the latest-start deadline backstop, which remains in force unchanged.
* **warm-keep pricing** (``StabilityLayer.keep_bonus``): while jobs are
  queued, each live instance's keep test gains slack equal to its
  relaunch overhead (acquisition + setup billed idle, plus each resident
  task's checkpoint + launch delay) amortized over D̂ and scaled by the
  queue pressure — keeping capacity warm through a dear phase is priced
  against the relaunch overhead a strike-chaser pays on every dip.

``benchmarks/bench_stability.py`` pins the acceptance trade-off: on the
bundled OU market, eva-stability holds the max pending-queue length below
always-defer eva-autoscale at a total cost within 5 %.
"""
from __future__ import annotations

from typing import Optional

from ..autoscale.admission import AdmissionController
from .layers import AdmissionLayerBase, relaunch_penalty


class StabilityController(AdmissionController):
    """Drift-plus-penalty admission over the pending queue.

    Subclasses ``AdmissionController``'s review loop (latest-start
    deadline bound, re-deferral hysteresis, forecaster caching all
    inherited) and replaces the pure strike test with the Lyapunov
    trade-off above.  ``v`` is the cost-vs-stability dial.
    """

    def __init__(self, catalog, forecaster=None, *, v: float = 32.0,
                 strike: float = 1.0, **kw):
        super().__init__(catalog, forecaster, strike=strike, **kw)
        assert v >= 0.0
        self.v = float(v)

    def _drift_dominates(self, jid: int, rp_f: float, rp_a: float) -> bool:
        """Queue backlog outweighs the premium penalty: admit."""
        q = self._held_rounds.get(jid, 0)
        return q * rp_a > self.v * (rp_f - self.strike * rp_a) + 1e-12

    def _admit_now(self, jid: int, rp_f: float, rp_a: float) -> bool:
        return (super()._admit_now(jid, rp_f, rp_a)
                or self._drift_dominates(jid, rp_f, rp_a))

    def _re_defer(self, jid: int, rp_f: float, rp_a: float) -> bool:
        # a job whose backlog would re-admit it immediately is never
        # bounced back to the queue by a price spike
        return (super()._re_defer(jid, rp_f, rp_a)
                and not self._drift_dominates(jid, rp_f, rp_a))


class StabilityLayer(AdmissionLayerBase):
    """Queue-stability-aware admission + warm-keep pricing, written purely
    against the policy-stack hooks (``pre_round`` / ``keep_bonus`` /
    ``on_pressure``)."""

    name = "stability"

    def __init__(self, controller=None, *, v: float = 32.0,
                 strike: float = 0.9, warm_keep: bool = True,
                 warm_ref: float = 4.0):
        super().__init__(controller)
        self.v = float(v)
        self.strike = float(strike)
        self.warm_keep = bool(warm_keep)
        self.warm_ref = float(warm_ref)  # queue length of full warm pressure
        self.queue_peak = 0  # max held-queue length observed
        self.warm_rounds = 0  # rounds where the warm-keep slack was active

    def _make_controller(self, catalog, type_mask):
        return StabilityController(catalog, v=self.v, strike=self.strike,
                                   type_mask=type_mask)

    def pre_round(self, view, d_hat_s):
        view, resumed = super().pre_round(view, d_hat_s)
        if len(self.last_held) > self.queue_peak:
            self.queue_peak = len(self.last_held)
        return view, resumed

    def keep_bonus(self, raw, cat, view) -> Optional[object]:
        """Warm-keep slack: while jobs are queued, an instance's relaunch
        overhead (amortized over D̂, scaled by queue pressure) is priced
        into its keep test — capacity that queued jobs will soon need is
        held through a dear phase instead of being cycled."""
        if not (self.warm_keep and self.last_held):
            return None
        self.warm_rounds += 1
        sched = self.sched
        pressure = min(1.0, len(self.last_held) / max(self.warm_ref, 1e-9))
        d_hr = max(sched.estimator.d_hat() / 3600.0, 1e-9)
        task_workload = view.task_workload
        scale = sched.migration_delay_scale

        def warm_bonus(k: int, tids) -> float:
            return pressure * relaunch_penalty(cat, k, k, tids,
                                               task_workload, scale) / d_hr

        return warm_bonus

    def summary(self) -> dict:
        out = super().summary()
        out["queue_peak"] = self.queue_peak
        out["warm_rounds"] = self.warm_rounds
        return out
