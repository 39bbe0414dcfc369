"""Configuration diffing: turn an abstract ClusterConfig into an execution
plan against live instances, minimizing actual task migrations.

Algorithm-level configurations are anonymous (type, task-set) slots.  The
executor matches each slot to a live instance of the same type maximizing
task overlap (greedy by overlap size), so tasks that stay on their matched
instance do not migrate.  The same plan is used to *estimate* migration cost
M_F / M_P for the ensemble criterion (§4.5) before committing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .catalog import Catalog
from .cluster_types import ClusterConfig
from .workloads import (INSTANCE_ACQUISITION_S, INSTANCE_SETUP_S, WORKLOADS,
                        checkpoint_size_gb)


@dataclasses.dataclass
class LiveInstance:
    instance_id: int
    type_index: int
    task_ids: Tuple[int, ...]


@dataclasses.dataclass
class Migration:
    task_id: int
    src_instance: Optional[int]  # None = task was pending (fresh launch)
    dst_slot: int  # index into plan.slots


@dataclasses.dataclass
class Plan:
    # slot -> (type_index, task_ids, matched live instance id or None)
    slots: List[Tuple[int, Tuple[int, ...], Optional[int]]]
    migrations: List[Migration]
    terminations: List[int]  # live instance ids
    launches: List[int]  # slot indices needing a fresh instance

    @property
    def num_migrations(self) -> int:
        return len(self.migrations)


def diff_configs(live: Sequence[LiveInstance], new: ClusterConfig) -> Plan:
    task_loc: Dict[int, int] = {}
    for inst in live:
        for t in inst.task_ids:
            task_loc[t] = inst.instance_id
    by_id = {i.instance_id: i for i in live}

    # Greedy matching: per type, (slot, live instance) pairs by overlap.
    # Only pairs that actually share a task are enumerated (O(total tasks)
    # via the task-location index, instead of slots × live set
    # intersections — quadratic in fleet size for a same-type fleet);
    # the zero-overlap pairs the dense enumeration used to sort behind
    # them are reproduced below by handing unmatched slots the lowest
    # unused same-type instance ids, which is exactly where the
    # (-overlap, slot, instance_id) order landed them.
    ov_count: Dict[Tuple[int, int], int] = {}
    for slot, (k, tids) in enumerate(new.assignments):
        for t in tids:
            iid = task_loc.get(t)
            if iid is not None and by_id[iid].type_index == k:
                key = (slot, iid)
                ov_count[key] = ov_count.get(key, 0) + 1
    pairs = [(-ov, slot, iid) for (slot, iid), ov in ov_count.items()]
    pairs.sort()
    slot_match: Dict[int, int] = {}
    used = set()
    for _nov, slot, iid in pairs:
        if slot in slot_match or iid in used:
            continue
        slot_match[slot] = iid
        used.add(iid)
    # zero-overlap phase: slots ascending, each takes the smallest unused
    # live instance id of its type (a per-type cursor over the sorted ids
    # keeps this linear — `used` only grows, so skipped ids stay skipped)
    ids_of_type: Dict[int, List[int]] = {}
    for inst in live:
        ids_of_type.setdefault(inst.type_index, []).append(inst.instance_id)
    cursor: Dict[int, int] = {}
    for k in ids_of_type:
        ids_of_type[k].sort()
        cursor[k] = 0
    for slot, (k, _tids) in enumerate(new.assignments):
        if slot in slot_match:
            continue
        ids = ids_of_type.get(k)
        if ids is None:
            continue
        c = cursor[k]
        while c < len(ids) and ids[c] in used:
            c += 1
        cursor[k] = c
        if c < len(ids):
            slot_match[slot] = ids[c]
            used.add(ids[c])
            cursor[k] = c + 1

    slots, migrations, launches = [], [], []
    for slot, (k, tids) in enumerate(new.assignments):
        matched = slot_match.get(slot)
        slots.append((k, tuple(tids), matched))
        if matched is None:
            launches.append(slot)
        stay = set(by_id[matched].task_ids) if matched is not None else set()
        for t in tids:
            if t in stay:
                continue
            migrations.append(Migration(t, task_loc.get(t), slot))
    terminations = [i.instance_id for i in live if i.instance_id not in used]
    return Plan(slots, migrations, terminations, launches)


def task_move_cost(catalog: Catalog, workload: int, src_k: int, dst_k: int,
                   delay_scale: float = 1.0) -> float:
    """$ cost of moving one resident task from an instance of type ``src_k``
    to one of type ``dst_k``: checkpoint + launch delay billed idle on both
    ends, plus — when the types live in different regions of a multi-region
    catalog — the checkpoint transfer time (also billed on both ends) and
    the egress fee.  Single source of truth for the per-task move price the
    keep test, the arbitrage pass, and the plan M terms all consume."""
    w = WORKLOADS[workload]
    delay = (w.checkpoint_delay_s + w.launch_delay_s) * delay_scale
    cost = 0.0
    if catalog.transfer is not None and catalog.region_ids is not None:
        r_s, r_d = catalog.region_of(src_k), catalog.region_of(dst_k)
        if r_s != r_d:
            gb = checkpoint_size_gb(workload)
            delay += catalog.transfer.transfer_time_s(r_s, r_d, gb) * delay_scale
            cost += catalog.transfer.egress_usd(r_s, r_d, gb)
    return cost + delay / 3600.0 * float(catalog.costs[src_k]
                                         + catalog.costs[dst_k])


def migration_cost(plan: Plan, live: Sequence[LiveInstance], catalog: Catalog,
                   task_workload: Dict[int, int],
                   delay_scale: float = 1.0,
                   task_ckpt_region: Optional[Dict[int, int]] = None) -> float:
    """Dollar estimate of a plan's migration overhead (§4.5 M term).

    Per migrated task: (checkpoint + launch delay) during which both the
    source and destination instances are provisioned but the task is idle.
    Per fresh launch: acquisition + setup time billed idle.

    On a multi-region catalog, a migration whose source and destination
    types live in different regions additionally pays the checkpoint
    transfer: the transfer *time* (snapshot GB over the inter-region
    bandwidth) billed idle on both ends, plus the egress fee in dollars —
    the explicit penalty the cross-region reconfiguration trade-off weighs
    against price dispersion.  ``task_ckpt_region`` (task id → region of its
    durable checkpoint, from ``SchedulerView``) prices the same transfer for
    *pending* tasks whose checkpoint was stranded by a reclaim, so restores
    are charged in the model exactly as the simulator bills them.
    """
    by_id = {i.instance_id: i for i in live}
    cross = catalog.transfer is not None and catalog.region_ids is not None
    cost = 0.0
    for slot in plan.launches:
        k = plan.slots[slot][0]
        cost += (INSTANCE_ACQUISITION_S + INSTANCE_SETUP_S) / 3600.0 * catalog.costs[k]
    for m in plan.migrations:
        wl = task_workload[m.task_id]
        dst_k = plan.slots[m.dst_slot][0]
        if m.src_instance is not None:
            cost += task_move_cost(catalog, wl,
                                   by_id[m.src_instance].type_index, dst_k,
                                   delay_scale)
            continue
        # pending task: launch delay billed on the destination only, plus a
        # cross-region restore of any stranded checkpoint
        w = WORKLOADS[wl]
        delay = (w.checkpoint_delay_s + w.launch_delay_s) * delay_scale
        if cross and task_ckpt_region is not None:
            r_s = task_ckpt_region.get(m.task_id)
            r_d = catalog.region_of(dst_k)
            if r_s is not None and r_s != r_d:
                gb = checkpoint_size_gb(wl)
                delay += (catalog.transfer.transfer_time_s(r_s, r_d, gb)
                          * delay_scale)
                cost += catalog.transfer.egress_usd(r_s, r_d, gb)
        cost += delay / 3600.0 * float(catalog.costs[dst_k])
    return float(cost)
