"""Partial Reconfiguration (§4.5).

Keeps every live instance whose task set is still cost-efficient
(TNRP(T_i) ≥ C_i after completions / observed interference) and re-packs only

  * tasks from recently submitted jobs not yet assigned to any instance, and
  * tasks on instances that are no longer cost-efficient,

via Algorithm 1.  Multi-task RP penalties are computed over the *system-wide*
job membership (non-migrating siblings still count).

``type_mask`` restricts which instance types may be used (region pinning);
it applies to reservation prices, the keep/evict cost-efficiency test,
spare-capacity best-fit, and the Algorithm-1 repack.  ``region_caps``
bounds per-region instance counts: kept instances consume their region's
budget and the repack only provisions into the remaining headroom (overflow
goes to the next-cheapest region).  On a multi-region catalog without mask
or caps, repacked tasks are priced across every region's current prices.

``keep_bonus(k, tids) -> $/h`` shifts the keep test by a per-instance slack.
Two schedulers use it:

* multi-region: a *positive* bonus equal to the amortized cost of actually
  moving the set elsewhere (cross-region checkpoint transfer + egress over
  the D-hat horizon), so instances are only evicted toward a cheaper market
  when the move pays for itself;
* credit-aware (burstable): the difference between the planning cost of a
  *fresh* instance of the type and the effective cost of *this* instance at
  its current credit balance.  The slack decays toward zero as the balance
  drains and turns negative once the instance forecasts worse than a fresh
  launch — at zero balance the keep test effectively compares TNRP against
  ``cost / baseline_fraction``, so exhausted instances are evicted into the
  repack set exactly when the throughput collapse makes the move worth its
  migration cost under the ensemble's S·D̂ > ΔM criterion.

``credit_horizon_s`` snapshots the catalog through
``catalog.credit_priced`` (fresh-launch balances) before any pricing, same
as ``full_reconfiguration``.
"""
from __future__ import annotations

from typing import (Callable, Iterable, List, Optional, Sequence, Set,
                    Tuple)

import numpy as np

from .catalog import Catalog
from .cluster_types import Assignment, ClusterConfig, TaskSet
from .full_reconfig import EPS, evaluate_assignments, full_reconfiguration
from .plan import LiveInstance
from .reservation_price import job_rp_sums, reservation_prices
from .throughput_table import ThroughputTable


def partial_reconfiguration(tasks: TaskSet, live_assignments: Sequence[Assignment],
                            pending_ids: Set[int], catalog: Catalog,
                            table: Optional[ThroughputTable] = None, *,
                            interference_aware: bool = True,
                            multi_task_aware: bool = True,
                            engine: str = "numpy",
                            time_s: Optional[float] = None,
                            type_mask: Optional[np.ndarray] = None,
                            region_caps: Optional[
                                Sequence[Optional[int]]] = None,
                            keep_bonus: Optional[
                                Callable[[int, Tuple[int, ...]], float]
                            ] = None,
                            credit_horizon_s: Optional[float] = None
                            ) -> ClusterConfig:
    if time_s is not None:
        catalog = catalog.at(time_s)  # all downstream prices from one instant
    if credit_horizon_s is not None:
        catalog = catalog.credit_priced(credit_horizon_s)
    live_task_ids = {t for _, tids in live_assignments for t in tids}
    # Drop completed tasks from live assignments.
    system_ids = set(tasks.ids.tolist())
    trimmed: List[Assignment] = []
    for k, tids in live_assignments:
        alive = tuple(t for t in tids if t in system_ids)
        if alive:
            trimmed.append((k, alive))

    repack: Set[int] = set(pending_ids) & system_ids
    keep: List[Assignment] = []
    if trimmed:
        tnrps, costs = evaluate_assignments(trimmed, tasks, catalog, table,
                                            multi_task_aware,
                                            type_mask=type_mask)
        for (k, tids), s, c in zip(trimmed, tnrps, costs):
            # keep_bonus amortizes the cost of *moving* this set (multi-region:
            # checkpoint transfer + egress + relaunch over the D-hat horizon)
            # into the keep test: evicting for a cheaper market only pays off
            # if the price gap beats the migration penalty.
            slack = keep_bonus(k, tids) if keep_bonus is not None else 0.0
            if s >= c - slack - EPS:
                keep.append((k, tids))
            else:  # no longer cost-efficient -> evict for re-packing
                repack |= set(tids)

    if not repack:
        return ClusterConfig(keep)

    rp_all = reservation_prices(tasks, catalog, type_mask=type_mask)
    job_rp_all = job_rp_sums(tasks, rp_all) if multi_task_aware else None

    # First, best-fit repack tasks into spare capacity on KEPT instances
    # (no extra provisioning, no migration of existing tenants) whenever the
    # grown set stays cost-efficient under TNRP.
    keep = [list(a) for a in keep]
    for tid in sorted(repack, key=lambda t: -rp_all[tasks.row(t)]):
        row = tasks.row(tid)
        best, best_left = -1, np.inf
        for i, (k, tids) in enumerate(keep):
            fam = catalog.family_ids[k]
            used = tasks.demand_by_family[
                [tasks.row(x) for x in tids], fam, :].sum(axis=0)
            d = tasks.demand_by_family[row, fam, :]
            if np.any(used + d > catalog.capacities[k] + EPS):
                continue
            grown = (k, tuple(tids) + (tid,))
            s, c = evaluate_assignments([grown], tasks, catalog, table,
                                        multi_task_aware,
                                        type_mask=type_mask)
            if s[0] < c[0] - EPS:
                continue
            left = float(((catalog.capacities[k] - used - d)
                          / np.maximum(catalog.capacities[k], 1.0)).sum())
            if left < best_left:
                best, best_left = i, left
        if best >= 0:
            keep[best][1] = tuple(keep[best][1]) + (tid,)
            repack.discard(tid)
    keep = [(k, tuple(tids)) for k, tids in keep]

    if not repack:
        return ClusterConfig(keep)
    # Kept instances consume their region's instance-count budget; the
    # Algorithm-1 repack only gets the remaining headroom.
    sub_caps = region_caps
    if region_caps is not None and catalog.region_ids is not None:
        kept_per_region = [0] * len(region_caps)
        for k, _ in keep:
            kept_per_region[catalog.region_of(k)] += 1
        sub_caps = [None if c is None else max(int(c) - kept_per_region[r], 0)
                    for r, c in enumerate(region_caps)]
    sub = tasks.subset(sorted(repack))
    rows = np.array([tasks.row(t) for t in sub.ids.tolist()])
    packed = full_reconfiguration(
        sub, catalog, table, interference_aware=interference_aware,
        multi_task_aware=multi_task_aware, engine=engine,
        rp=rp_all[rows],
        job_rp=job_rp_all[rows] if job_rp_all is not None else None,
        type_mask=type_mask, region_caps=sub_caps)
    return ClusterConfig(keep + packed.assignments)


def incremental_reconfiguration(tasks: TaskSet,
                                live: Sequence[LiveInstance],
                                dirty_ids: Iterable[int],
                                pending_ids: Set[int], catalog: Catalog,
                                table: Optional[ThroughputTable] = None, *,
                                evacuate: Iterable[int] = (),
                                interference_aware: bool = True,
                                multi_task_aware: bool = True,
                                engine: str = "numpy",
                                time_s: Optional[float] = None,
                                type_mask: Optional[np.ndarray] = None,
                                region_caps: Optional[
                                    Sequence[Optional[int]]] = None,
                                keep_bonus: Optional[
                                    Callable[[int, Tuple[int, ...]], float]
                                ] = None,
                                credit_horizon_s: Optional[float] = None,
                                max_dirty_fraction: float = 0.5
                                ) -> Tuple[ClusterConfig, Optional[str]]:
    """Incremental partial reconfiguration: re-plan only the disturbance.

    ``dirty_ids`` are the live instance ids a pressure signal touched (see
    ``repro.policies.pressure.dirty_instance_ids``); ``evacuate`` is the
    subset that must additionally be vacated (spot revocations, credit
    drains).  Every *clean* live instance passes through verbatim, and one
    ordinary ``partial_reconfiguration`` runs over just the affected
    sub-problem — dirty instances keep/evict-tested as usual, evacuated
    instances' tasks plus ``pending_ids`` as the repack set, region budgets
    reduced by the clean fleet's footprint.  Per-round planning latency
    therefore scales with the size of the disturbance, not the cluster.

    Returns ``(config, fallback_reason)``.  ``fallback_reason`` is None when
    the incremental path ran; otherwise the call transparently degraded to a
    full ``partial_reconfiguration`` because locality would change the
    answer:

    * ``"dirty-fraction"`` — the disturbance touches more than
      ``max_dirty_fraction`` of the live fleet (or there is no live fleet),
      so a cluster-wide re-plan is at least as cheap as stitching;
    * ``"job-straddle"`` — ``multi_task_aware`` and some affected task's job
      also has tasks on clean instances: the §4.4 job-RP penalty must see
      the whole job, so the sub-problem cannot be priced locally.

    When no job straddles the cut, the affected sub-problem's reservation
    prices and job-RP sums equal the system-wide ones (RP is per-task,
    catalog-only), so the incremental plan is bit-identical to the clean
    pass-through plus ``partial_reconfiguration`` on the affected subset —
    pinned by ``tests/test_incremental.py``.

    Caller contract (scheduler views satisfy it): ``live`` placements
    reference only tasks present in ``tasks``.  Clean instances are NOT
    trimmed of completed tasks here — that O(cluster) sweep is exactly what
    this path avoids.
    """
    evac = set(evacuate)
    dirty = set(dirty_ids) | evac
    affected = [i for i in live if i.instance_id in dirty]
    clean = [i for i in live if i.instance_id not in dirty]
    kw = dict(interference_aware=interference_aware,
              multi_task_aware=multi_task_aware, engine=engine,
              time_s=time_s, type_mask=type_mask, keep_bonus=keep_bonus,
              credit_horizon_s=credit_horizon_s)

    def _fallback(reason: str) -> Tuple[ClusterConfig, str]:
        kept_live = [(i.type_index, i.task_ids) for i in live
                     if i.instance_id not in evac]
        pend = set(pending_ids)
        for i in live:
            if i.instance_id in evac:
                pend |= set(i.task_ids)
        cfg = partial_reconfiguration(tasks, kept_live, pend, catalog,
                                      table, region_caps=region_caps, **kw)
        return cfg, reason

    if not live or len(affected) > max_dirty_fraction * len(live):
        return _fallback("dirty-fraction")

    pending = set(pending_ids) & set(tasks.ids.tolist()) \
        if pending_ids else set()
    evac_tasks: Set[int] = set()
    for i in affected:
        if i.instance_id in evac:
            evac_tasks |= set(i.task_ids)
    sub_ids = sorted({t for i in affected for t in i.task_ids} | pending)
    if not sub_ids:
        return (ClusterConfig([(i.type_index, i.task_ids) for i in clean]),
                None)
    if multi_task_aware:
        jobs, counts = np.unique(
            tasks.job_ids[[tasks.row(t) for t in sub_ids]],
            return_counts=True)
        for j, n in zip(jobs.tolist(), counts.tolist()):
            if tasks.job_size(j) != n:
                return _fallback("job-straddle")
    sub_caps = region_caps
    if region_caps is not None and catalog.region_ids is not None:
        clean_per_region = [0] * len(region_caps)
        for i in clean:
            clean_per_region[catalog.region_of(i.type_index)] += 1
        sub_caps = [None if c is None
                    else max(int(c) - clean_per_region[r], 0)
                    for r, c in enumerate(region_caps)]
    sub = tasks.subset(sub_ids)
    sub_live = [(i.type_index, i.task_ids) for i in affected
                if i.instance_id not in evac]
    cfg = partial_reconfiguration(sub, sub_live, pending | evac_tasks,
                                  catalog, table, region_caps=sub_caps, **kw)
    out = [(i.type_index, i.task_ids) for i in clean] + cfg.assignments
    return ClusterConfig(out), None
