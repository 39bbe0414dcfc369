"""Core data model: tasks, jobs, instances, cluster configurations.

The scheduler-facing representation is deliberately array-friendly: a
``TaskSet`` holds (T, F, R) demand tensors so reservation prices and packing
feasibility are vectorized across all tasks and instance types at once.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .catalog import FAMILIES, NUM_RESOURCES, Catalog
from .workloads import WORKLOADS

if TYPE_CHECKING:  # pragma: no cover - annotation-only import
    from .serving import ServiceSpec


@dataclasses.dataclass
class Task:
    task_id: int
    job_id: int
    workload: int  # index into the workload-profile table (interference key)
    # demands[f] = (gpu, cpu, ram) for family f; missing families fall back to
    # demands[0] (the "p3" vector), mirroring Table 7.
    demands: Dict[str, Tuple[float, float, float]]

    def demand_for_family(self, family: str) -> Tuple[float, float, float]:
        return self.demands.get(family, self.demands.get("p3"))


@dataclasses.dataclass
class Job:
    job_id: int
    workload: int
    arrival_time: float  # seconds
    duration_s: float  # standalone (no-interference) runtime
    n_tasks: int
    tasks: List[Task] = dataclasses.field(default_factory=list)
    # price-pressure autoscaling: a deferrable job may be held pending (not
    # admitted, zero billing) while the market is dear; ``deadline_s`` is the
    # absolute completion deadline (None = none).  Defaults keep every
    # existing trace on the admit-immediately path.
    deadline_s: Optional[float] = None
    deferrable: bool = False
    # serving axis: a job carrying a ServiceSpec is a fleet of inference
    # replicas — it runs for a fixed wall-clock window (duration_s) and is
    # billed by served-request latency against its utility curve instead of
    # by iteration progress.  Service jobs are never deferrable batch.
    service: Optional["ServiceSpec"] = None
    # runtime bookkeeping (filled by the simulator)
    completion_time: Optional[float] = None

    @property
    def is_service(self) -> bool:
        return self.service is not None

    @property
    def total_iters(self) -> float:
        # normalize standalone rate to 1 iter/sec
        return self.duration_s


@dataclasses.dataclass
class Instance:
    instance_id: int
    type_index: int  # into the catalog
    launch_time: float = 0.0  # when requested from the cloud
    ready_time: float = 0.0  # after acquisition + setup
    terminate_time: Optional[float] = None


# A cluster configuration: list of (type_index, tuple-of-task-ids).  Instances
# are anonymous at the algorithm level; the executor diffs configurations
# against live instances to minimize actual migrations.
Assignment = Tuple[int, Tuple[int, ...]]


@dataclasses.dataclass
class ClusterConfig:
    assignments: List[Assignment] = dataclasses.field(default_factory=list)

    def total_hourly_cost(self, catalog: Catalog) -> float:
        return float(sum(catalog.costs[k] for k, _ in self.assignments))

    def task_to_slot(self) -> Dict[int, int]:
        out = {}
        for slot, (_, tids) in enumerate(self.assignments):
            for t in tids:
                out[t] = slot
        return out

    def num_tasks(self) -> int:
        return sum(len(tids) for _, tids in self.assignments)


class TaskSet:
    """Array view over a list of tasks.

    demand_by_family : (T, F, R) — demand of task t if placed on family f
    job_ids, workloads : (T,) int64
    """

    def __init__(self, tasks: Sequence[Task]):
        self.tasks: Optional[List[Task]] = list(tasks)
        self.ids = np.array([t.task_id for t in self.tasks], dtype=np.int64)
        self.job_ids = np.array([t.job_id for t in self.tasks], dtype=np.int64)
        self.workloads = np.array([t.workload for t in self.tasks], dtype=np.int64)
        T = len(self.tasks)
        d = np.zeros((T, len(FAMILIES), NUM_RESOURCES), dtype=np.float64)
        for i, t in enumerate(self.tasks):
            for fi, fam in enumerate(FAMILIES):
                d[i, fi] = t.demand_for_family(fam)
        self.demand_by_family = d
        self._index_of = {tid: i for i, tid in enumerate(self.ids.tolist())}
        self._job_sizes: Optional[Dict[int, int]] = None

    @classmethod
    def from_arrays(cls, ids: np.ndarray, job_ids: np.ndarray,
                    workloads: np.ndarray, demand_by_family: np.ndarray,
                    tasks: Optional[Sequence[Task]] = None) -> "TaskSet":
        """Build directly from the array view, skipping the per-task Python
        loop — the fleet-scale constructor (``tasks`` objects optional; the
        planning engines only consume the arrays)."""
        self = cls.__new__(cls)
        self.tasks = list(tasks) if tasks is not None else None
        self.ids = np.asarray(ids, dtype=np.int64)
        self.job_ids = np.asarray(job_ids, dtype=np.int64)
        self.workloads = np.asarray(workloads, dtype=np.int64)
        self.demand_by_family = np.asarray(demand_by_family, dtype=np.float64)
        self._index_of = {tid: i for i, tid in enumerate(self.ids.tolist())}
        self._job_sizes = None
        return self

    def __len__(self) -> int:
        return self.ids.shape[0]

    def row(self, task_id: int) -> int:
        return self._index_of[task_id]

    def job_size(self, job_id: int) -> int:
        """Number of tasks of ``job_id`` in this set (cached)."""
        if self._job_sizes is None:
            uniq, cnt = np.unique(self.job_ids, return_counts=True)
            self._job_sizes = dict(zip(uniq.tolist(), cnt.tolist()))
        return self._job_sizes.get(job_id, 0)

    def subset(self, task_ids: Sequence[int]) -> "TaskSet":
        rows = [self._index_of[t] for t in task_ids]
        if self.tasks is not None:
            return TaskSet([self.tasks[r] for r in rows])
        rx = np.asarray(rows, dtype=np.int64)
        return TaskSet.from_arrays(self.ids[rx], self.job_ids[rx],
                                   self.workloads[rx],
                                   self.demand_by_family[rx])


_task_counter = itertools.count()


def make_task(job_id: int, workload: int, task_id: Optional[int] = None) -> Task:
    prof = WORKLOADS[workload]
    demands = {fam: prof.demand_for_family(fam) for fam in FAMILIES}
    tid = next(_task_counter) if task_id is None else task_id
    return Task(task_id=tid, job_id=job_id, workload=workload, demands=demands)


def make_job(job_id: int, workload: int, arrival_time: float, duration_s: float,
             n_tasks: Optional[int] = None, deadline_s: Optional[float] = None,
             deferrable: bool = False,
             service: Optional["ServiceSpec"] = None) -> Job:
    prof = WORKLOADS[workload]
    n = prof.n_tasks if n_tasks is None else n_tasks
    job = Job(job_id=job_id, workload=workload, arrival_time=arrival_time,
              duration_s=duration_s, n_tasks=n, deadline_s=deadline_s,
              deferrable=deferrable, service=service)
    job.tasks = [make_task(job_id, workload) for _ in range(n)]
    return job
