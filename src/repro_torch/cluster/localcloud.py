"""Physical-mode harness (``repro/cluster/localcloud.py``): Eva scheduling
real PyTorch training jobs.

The analogue of the paper's EC2 deployment (§6.2), scaled to one machine:
"instances" are slots billed by wall-clock uptime, tasks are genuine
training loops (the port's ``models/steps.py``) run by worker threads, task
migration checkpoints the train state through ``train.checkpoint`` and
restarts the loop on the destination instance, and the monitor reports the
observed steps/s back to the scheduler.  The workers run on ``device``: the
card unless the caller asks for the CPU, and without a card ``LocalCloud``
raises.  On the card each worker launches on a CUDA stream of its own and
waits for that stream alone, so co-resident jobs contend for the card's SMs
(and for the host's launch thread) as the reference's contend for its CPU
cores.  A worker that raises keeps the exception as ``_Worker.error``;
``LocalCloud.run`` raises it at the next round, after stopping every other
worker.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

import torch

from .. import resolve_device
from ..core.catalog import Catalog
from ..core.cluster_types import ClusterConfig, Task, TaskSet
from ..core.plan import LiveInstance, diff_configs
from ..core.scheduler import SchedulerBase, SchedulerView
from ..data.pipeline import SyntheticTokens, shard_batch
from ..models.steps import init_train_state, make_train_step
from ..train.checkpoint import restore_checkpoint, save_checkpoint
from ..train.optimizer import OptConfig


@dataclasses.dataclass
class LocalJob:
    job_id: int
    workload: int
    arch_cfg: object  # ArchConfig
    total_steps: int
    demand: tuple  # (gpu, cpu, ram)
    steps_done: int = 0
    standalone_sps: Optional[float] = None  # steps/s solo (calibration)
    done: bool = False


class _Worker(threading.Thread):
    """Runs one task's training loop until stopped; counts steps."""

    def __init__(self, job: LocalJob, ckpt_dir: str, device="cuda"):
        super().__init__(daemon=True)
        self.job = job
        self.ckpt_dir = ckpt_dir
        self.device = resolve_device(device)
        self.stop_flag = threading.Event()
        self.steps_this_run = 0
        self.window: List[float] = []  # recent step timestamps
        self.error: Optional[BaseException] = None  # what ended run(), if any

    def run(self):
        try:
            self._train()
        except Exception as e:  # kept for the caller; the thread ends
            self.error = e

    def _train(self):
        cfg = self.job.arch_cfg
        device = self.device
        stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            try:
                state, step0, _ = restore_checkpoint(self.ckpt_dir,
                                                     device=device)
            except FileNotFoundError:
                state = init_train_state(
                    cfg, torch.Generator(device).manual_seed(self.job.job_id))
                step0 = 0
            step_fn = make_train_step(cfg, OptConfig(total_steps=max(
                self.job.total_steps, 10)))
            src = SyntheticTokens(cfg.vocab, 2, 32, seed=self.job.job_id,
                                  start_step=step0)
            step = step0
            while not self.stop_flag.is_set() and step < self.job.total_steps:
                batch = shard_batch(src.next_batch(), device)
                state, _ = step_fn(state, batch)
                if stream is not None:
                    stream.synchronize()  # this job's work, not the others'
                step += 1
                now = time.time()
                self.window.append(now)
                self.window = [t for t in self.window if now - t < 10.0]
            save_checkpoint(self.ckpt_dir, state, step)
        self.job.steps_done = step
        if step >= self.job.total_steps:
            self.job.done = True

    def raise_error(self) -> None:
        """Raises what ended ``run``, if anything did."""
        if self.error is not None:
            raise RuntimeError(f"the worker of job {self.job.job_id} failed: "
                               f"{self.error!r}") from self.error

    def throughput(self) -> float:
        self.raise_error()  # the monitor's read: a dead worker fails the round
        w = [t for t in self.window if time.time() - t < 10.0]
        if len(w) < 2:
            return 0.0
        return (len(w) - 1) / max(w[-1] - w[0], 1e-6)


class LocalCloud:
    """Drives a SchedulerBase against real threaded jobs on ``device``."""

    def __init__(self, catalog: Catalog, scheduler: SchedulerBase,
                 jobs: List[LocalJob], round_s: float = 4.0,
                 workdir: Optional[str] = None, *, device="cuda"):
        self.device = resolve_device(device)
        self.catalog = catalog
        self.scheduler = scheduler
        self.jobs = {j.job_id: j for j in jobs}
        self.round_s = round_s
        self.workdir = workdir or tempfile.mkdtemp(prefix="evalocal-")
        self._iid = itertools.count()
        # instance id -> (type_index, start_time, task ids)
        self.instances: Dict[int, dict] = {}
        self.workers: Dict[int, _Worker] = {}  # task id -> worker
        self.task_of_job: Dict[int, Task] = {}
        self.cost = 0.0
        self.migrations = 0
        for j in jobs:
            t = Task(task_id=j.job_id, job_id=j.job_id, workload=j.workload,
                     demands={"p3": tuple(map(float, j.demand))})
            self.task_of_job[j.job_id] = t

    def _ckpt_dir(self, tid: int) -> str:
        return os.path.join(self.workdir, f"task-{tid}")

    def _live_view(self):
        return [LiveInstance(i, inst["type"], tuple(sorted(inst["tasks"])))
                for i, inst in self.instances.items()]

    def _stop_worker(self, tid: int):
        w = self.workers.pop(tid, None)
        if w is not None:
            w.stop_flag.set()
            w.join(timeout=60)
            w.raise_error()

    def _start_worker(self, tid: int):
        job = self.jobs[tid]
        if job.done:
            return
        w = _Worker(job, self._ckpt_dir(tid), self.device)
        self.workers[tid] = w
        w.start()

    def step_round(self, now: float):
        # monitor: report observed normalized throughput
        for tid, w in list(self.workers.items()):
            job = self.jobs[tid]
            sps = w.throughput()
            if sps > 0 and job.standalone_sps:
                inst = next((i for i in self.instances.values()
                             if tid in i["tasks"]), None)
                if inst:
                    colo = [self.jobs[o].workload for o in inst["tasks"]
                            if o != tid]
                    if colo:
                        self.scheduler.observe_single(
                            job.workload, colo,
                            min(sps / job.standalone_sps, 1.0))
        live = [t for t, j in self.jobs.items() if not j.done]
        taskset = TaskSet([self.task_of_job[t] for t in live])
        placed = {t for i in self.instances.values() for t in i["tasks"]}
        view = SchedulerView(
            time=now, tasks=taskset,
            pending_ids={t for t in live if t not in placed},
            live=self._live_view(),
            task_workload={t: self.jobs[t].workload for t in live})
        config = self.scheduler.schedule(view)
        plan = diff_configs(self._live_view(), config)

        slot_inst = {}
        for slot, (k, tids, matched) in enumerate(plan.slots):
            if matched is not None:
                slot_inst[slot] = matched
            else:
                iid = next(self._iid)
                self.instances[iid] = {"type": k, "start": now, "tasks": set()}
                slot_inst[slot] = iid
        for mig in plan.migrations:
            tid = mig.task_id
            if mig.src_instance is not None:
                self._stop_worker(tid)  # checkpoint happens in worker exit
                self.instances[mig.src_instance]["tasks"].discard(tid)
                self.migrations += 1
            self.instances[slot_inst[mig.dst_slot]]["tasks"].add(tid)
            self._start_worker(tid)
        for iid in plan.terminations:
            inst = self.instances.pop(iid, None)
            if inst is not None:
                self.cost += (now - inst["start"]) / 3600.0 \
                    * self.catalog.costs[inst["type"]]

    def reap_done(self, now: float):
        for tid, job in self.jobs.items():
            if job.done and tid in self.workers:
                self._stop_worker(tid)
            if job.done:
                for inst in self.instances.values():
                    inst["tasks"].discard(tid)
        self.scheduler.on_event(now)

    def _stop_all_quietly(self):
        """Stops and joins every worker left, raising none of their errors:
        the one that ended ``run`` stands."""
        for w in self.workers.values():
            w.stop_flag.set()
        for w in self.workers.values():
            w.join(timeout=60)
        self.workers.clear()

    def run(self, timeout_s: float = 600.0) -> dict:
        t0 = time.time()
        try:
            while time.time() - t0 < timeout_s:
                now = time.time()
                self.reap_done(now)
                if all(j.done for j in self.jobs.values()):
                    break
                self.step_round(now)
                time.sleep(self.round_s)
        except BaseException:  # a worker's error: no job trains on after it
            self._stop_all_quietly()
            raise
        # final billing
        now = time.time()
        for iid, inst in list(self.instances.items()):
            self.cost += (now - inst["start"]) / 3600.0 \
                * self.catalog.costs[inst["type"]]
        for tid in list(self.workers):
            self._stop_worker(tid)
        return {"cost": self.cost, "migrations": self.migrations,
                "steps": {t: j.steps_done for t, j in self.jobs.items()},
                "all_done": all(j.done for j in self.jobs.values())}
