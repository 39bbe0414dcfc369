"""Forecast-driven admission control for deferrable jobs.

``AdmissionController`` scales the *job population itself* against price
pressure (the last axis on the ``PriceModel`` stack): deferrable batch
jobs are held in a pending queue while the market is dear and admitted
when it is cheap — bounded by per-job deadlines.  Mechanics, per
scheduling round (the controller runs before Algorithm 1 ever sees the
task set):

* every *deferrable, not-yet-started* job (``SchedulerView.deferrable`` ∩
  ``SchedulerView.pending``) is reviewed;
* its **strike test** compares the forecast effective $/throughput of
  running it over its estimated duration D̂_j (``PriceForecaster.
  forecast_catalog(...).credit_priced(...)`` — spot, region and credit
  axes all priced in) against ``strike`` × the same reservation price
  under the market's *long-run anchor* prices.  Below the strike the
  market is cheap *for this job's feasible types*: admit; above: hold;
* its **latest-start time** ``deadline − margin · D̂_j − overhead`` is the
  unconditional bound: once it arrives the job is admitted regardless of
  price (``forced``), so deadlines are met even on markets that never
  dip.  The simulator mirrors the same bound with a ``DEFER_DEADLINE``
  event that fires an immediate extra round (the shared pressure-signal
  wiring spot notices and credit exhaustion use), so a latest-start
  falling between rounds is not missed;
* an admitted-but-unstarted job is **re-deferred** when prices spike: if
  its forecast rises above the strike by more than ``hold_hysteresis``
  (hysteresis, because withdrawing an in-flight placement wastes the
  already-billed acquisition time), it returns to the pending queue and
  the executor withdraws its not-yet-launched placement.  Started jobs
  are never touched.

Duration estimates D̂_j come from ``SchedulerView.remaining_s`` (the same
runtime-estimate channel Stratus uses); jobs without one fall back to the
ensemble's D̂ horizon.  ``margin`` covers interference slowdown and
``ADMIT_OVERHEAD_S`` the instance acquisition + setup + one scheduling
round of latency, so "admit at latest start" still meets the deadline.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.catalog import Catalog
from ..core.reservation_price import reservation_prices
from ..core.workloads import INSTANCE_ACQUISITION_S, INSTANCE_SETUP_S
from .forecast import PriceForecaster

# Latest-start defaults: margin stretches the standalone duration estimate
# for interference slowdown; the overhead covers acquisition + setup + one
# round interval + launch latency.  The simulator's DEFER_DEADLINE backstop
# reads the live controller's margin/overhead (falling back to these
# defaults for controller-less schedulers) so the two sides agree on the
# bound even when the knobs are customized.
RUNTIME_MARGIN = 2.0
ADMIT_OVERHEAD_S = INSTANCE_ACQUISITION_S + INSTANCE_SETUP_S + 300.0 + 120.0


def latest_start_s(deadline_s: float, est_duration_s: float,
                   margin: float = RUNTIME_MARGIN,
                   overhead_s: float = ADMIT_OVERHEAD_S) -> float:
    """Last instant a job can be admitted and still meet its deadline."""
    return deadline_s - margin * max(est_duration_s, 0.0) - overhead_s


class AdmissionController:
    """Pending queue + strike test + deadline bound for deferrable jobs."""

    def __init__(self, catalog: Catalog,
                 forecaster: Optional[PriceForecaster] = None, *,
                 strike: float = 1.0, margin: float = RUNTIME_MARGIN,
                 overhead_s: float = ADMIT_OVERHEAD_S,
                 hold_hysteresis: float = 0.25,
                 min_horizon_s: float = 600.0,
                 type_mask: Optional[np.ndarray] = None):
        assert strike > 0.0 and margin >= 1.0 and hold_hysteresis >= 0.0
        self.catalog = catalog
        self.forecaster = forecaster or PriceForecaster.for_catalog(catalog)
        # restrict the strike test to the types the scheduler may actually
        # pack on (e.g. a region pin) — otherwise another region's cheap
        # window would admit a job the packer cannot place there
        self.type_mask = type_mask
        self.strike = float(strike)
        self.margin = float(margin)
        self.overhead_s = float(overhead_s)
        self.hold_hysteresis = float(hold_hysteresis)
        self.min_horizon_s = float(min_horizon_s)
        self._admitted: Set[int] = set()  # admitted, possibly unstarted
        self._force: Set[int] = set()  # deadline-pressure signals
        # per-job held-round backlog (the queue drift term stability-aware
        # subclasses weigh against the price premium)
        self._held_rounds: Dict[int, int] = {}
        # observability
        self.admissions = 0
        self.forced_admissions = 0
        self.re_deferrals = 0
        self.held_job_rounds = 0

    # -- signals -------------------------------------------------------------
    def note_deadline(self, job_ids: Sequence[int]) -> None:
        """A ``DEFER_DEADLINE`` signal arrived: these jobs' latest-start
        time has passed — admit them unconditionally at the next review."""
        self._force |= set(job_ids)

    # -- per-job pieces ------------------------------------------------------
    def _estimates(self, view) -> Dict[int, float]:
        """Job id -> estimated standalone duration (max over its tasks)."""
        est: Dict[int, float] = {}
        if view.remaining_s:
            ids = view.tasks.ids.tolist()
            jids = view.tasks.job_ids.tolist()
            for tid, jid in zip(ids, jids):
                r = view.remaining_s.get(tid)
                if r is not None:
                    est[jid] = max(est.get(jid, 0.0), float(r))
        return est

    def _job_rp(self, view, job_ids, cat: Catalog) -> float:
        sub = view.tasks.subset(job_ids)
        return float(reservation_prices(sub, cat,
                                        type_mask=self.type_mask).sum())

    # -- the admit/hold decision (subclass points) ---------------------------
    def queue_rounds(self, jid: int) -> int:
        """Rounds this job has been held so far (its share of the
        ``held_job_rounds`` queue backlog)."""
        return self._held_rounds.get(jid, 0)

    def _hold(self, jid: int, held: Set[int]) -> None:
        held.add(jid)
        self.held_job_rounds += 1
        self._held_rounds[jid] = self._held_rounds.get(jid, 0) + 1

    def _admit_now(self, jid: int, rp_f: float, rp_a: float) -> bool:
        """The strike test: admit while the forecast reservation price
        sits at or below ``strike`` × the long-run anchor.  Stability-aware
        subclasses extend this with a queue-drift term."""
        return rp_f <= self.strike * rp_a + 1e-12

    def _re_defer(self, jid: int, rp_f: float, rp_a: float) -> bool:
        """Re-deferral test for admitted-but-unstarted jobs: hysteresis,
        because withdrawing an in-flight placement wastes the already
        billed acquisition time — only a real spike re-defers."""
        return rp_f > self.strike * rp_a * (1.0 + self.hold_hysteresis) \
            + 1e-12

    # -- the round review ----------------------------------------------------
    def review(self, view, d_hat_s: float) -> Tuple[Set[int], Set[int]]:
        """Review every deferrable unstarted job at ``view.time``.

        Returns ``(held, forced)``: job ids to keep out of this round's
        task set, and jobs force-admitted by their latest-start bound this
        round (the scheduler routes those through its forced-partial
        path).  Jobs that started running are dropped from tracking.
        """
        if not view.deferrable:
            self._admitted.clear()
            self._force.clear()
            return set(), set()
        pending = view.pending if view.pending is not None else set()
        live_jobs = set(view.tasks.job_ids.tolist())
        # intersect with the jobs actually present in the view: an earlier
        # admission layer in a policy stack may already have stripped some
        # held jobs' tasks, and those are no longer this review's to judge.
        # Service jobs are never deferral candidates — holding a latency
        # job for a price dip forfeits utility it can never earn back.
        candidates = (set(view.deferrable) & pending & live_jobs
                      - set(view.service or ()))
        self._admitted &= live_jobs & pending  # started/done jobs drop out
        self._force &= live_jobs
        self._held_rounds = {j: r for j, r in self._held_rounds.items()
                             if j in live_jobs}
        if not candidates:
            return set(), set()

        now = view.time
        est = self._estimates(view)
        deadlines = view.deadline_s or {}
        job_tasks: Dict[int, list] = {}
        for tid, jid in zip(view.tasks.ids.tolist(),
                            view.tasks.job_ids.tolist()):
            job_tasks.setdefault(jid, []).append(tid)

        held: Set[int] = set()
        forced: Set[int] = set()
        # per-horizon cache of both sides of the strike comparison
        cache: Dict[float, Tuple[Catalog, Catalog]] = {}
        anchor = self.forecaster.anchor_catalog(self.catalog, now)
        for jid in sorted(candidates):
            dur = est.get(jid, d_hat_s)
            dl = deadlines.get(jid)
            if jid in self._force or (
                    dl is not None
                    and now >= latest_start_s(dl, dur, self.margin,
                                              self.overhead_s)):
                # the deadline bound: admit regardless of price
                if jid not in self._admitted:
                    self.forced_admissions += 1
                    self.admissions += 1
                    forced.add(jid)
                self._admitted.add(jid)
                self._force.discard(jid)
                continue
            h = max(dur, self.min_horizon_s)
            pair = cache.get(h)
            if pair is None:
                pair = (self.forecaster.forecast_catalog(
                    self.catalog, now, h).credit_priced(h),
                    anchor.credit_priced(h))
                cache[h] = pair
            rp_f = self._job_rp(view, job_tasks[jid], pair[0])
            rp_a = self._job_rp(view, job_tasks[jid], pair[1])
            if jid in self._admitted:
                if self._re_defer(jid, rp_f, rp_a):
                    self._admitted.discard(jid)
                    self.re_deferrals += 1
                    self._hold(jid, held)
                continue
            if self._admit_now(jid, rp_f, rp_a):
                self._admitted.add(jid)
                self.admissions += 1
            else:
                self._hold(jid, held)
        return held, forced
