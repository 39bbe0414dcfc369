"""Workload profiles (paper Table 7) and the co-location interference model.

Each workload has a per-family resource-demand vector (GPU tasks demand CPUs
on P3; CPU tasks need fewer vCPUs on C7i/R7i due to higher clocks — the
parenthesized numbers in Table 7), plus measured checkpoint/launch delays.

The ground-truth pairwise interference matrix models Figure 1 of the paper
(normalized co-location throughput in [0.64, 1.0], i.e. 0-36 % degradation).
Figure 1's raw cell values are not machine-readable from the paper, so we
encode a fixed seeded matrix with the same structure the paper describes:
disk/CPU/cache-heavy pairs (graph embedding, bioinfo, CFD) interfere most,
GPU-compute-bound pairs least.  The *scheduler never sees this matrix* — it
only observes throughputs through the ThroughputMonitor, exactly as in §4.3.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .catalog import FAMILIES, NUM_RESOURCES


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    name: str
    # demand[family] -> (gpu, cpu, ram); families without an entry fall back
    # to the "p3" vector.
    demands: dict
    checkpoint_delay_s: float
    launch_delay_s: float
    n_tasks: int = 1  # tasks per job for this workload (ResNet18 has 2/4)
    # Burst duty cycle: fraction of wall time the task actually drives the
    # CPU (burstable-instance credit drain; 1.0 = fully compute-bound).
    # Only the credit layer reads it — on non-burstable catalogs it is inert.
    burst_duty: float = 1.0
    # Autoscaling defaults (price-pressure admission control): jobs of a
    # deferrable workload may be held pending while the market is dear, and
    # ``deadline_s`` is the default completion deadline relative to arrival
    # (None = no deadline).  Trace generators stamp these onto each ``Job``
    # (which may override them per job); the Table-7 profiles keep the
    # non-deferrable defaults, so existing traces are untouched.
    deferrable: bool = False
    deadline_s: Optional[float] = None
    # Serving axis: ``kind`` is "batch" (Table-7 iteration workloads) or
    # "service" (latency-SLO inference replicas).  For service workloads the
    # three fields below are the per-replica serving defaults that trace
    # generators fold into each job's ``ServiceSpec``; the simulator and
    # scheduler only ever read the spec on the ``Job``, so these are inert
    # for batch workloads and for any code path that predates the axis.
    kind: str = "batch"
    per_replica_rps: float = 0.0
    base_latency_ms: float = 0.0
    target_p99_ms: Optional[float] = None

    @property
    def is_service(self) -> bool:
        return self.kind == "service"

    def demand_for_family(self, family: str) -> tuple:
        return self.demands.get(family, self.demands["p3"])


def _w(name, gpu, cpu_p3, ram, ckpt, launch, cpu_c=None, n_tasks=1,
       duty=1.0):
    d = {"p3": (float(gpu), float(cpu_p3), float(ram))}
    if cpu_c is not None:  # CPU-only task: cheaper CPU demand on C7i/R7i
        d["c7i"] = (float(gpu), float(cpu_c), float(ram))
        d["r7i"] = (float(gpu), float(cpu_c), float(ram))
    return WorkloadProfile(name, d, float(ckpt), float(launch), n_tasks,
                           float(duty))


# Table 7 (demands per task; checkpoint/launch migration delays in seconds).
# Burst duty cycles are beyond-paper: a3c alternates environment stepping
# with learner updates and openfoam interleaves I/O-bound write phases, so
# neither saturates a burstable instance's CPU the way the dense-compute
# workloads do (duty 1.0).
BATCH_WORKLOADS: tuple = (
    _w("resnet18-2", 1, 4, 24, 2, 80, n_tasks=2),
    _w("resnet18-4", 1, 4, 24, 2, 80, n_tasks=4),
    _w("vit", 2, 8, 60, 3, 143),
    _w("cyclegan", 1, 4, 10, 7, 2),
    _w("gpt2", 4, 4, 10, 30, 15),
    _w("graphsage", 1, 8, 50, 2, 160),
    _w("gcn", 0, 12, 40, 2, 28, cpu_c=6),
    _w("a3c", 0, 10, 8, 2, 10, cpu_c=4, duty=0.7),
    _w("diamond", 0, 14, 16, 8, 12, cpu_c=8),
    _w("openfoam", 0, 8, 8, 21, 1, cpu_c=6, duty=0.85),
)


def _sw(name, gpu, cpu_p3, ram, ckpt, launch, rps, base_ms, target_ms,
        cpu_c=None):
    base = _w(name, gpu, cpu_p3, ram, ckpt, launch, cpu_c=cpu_c)
    return dataclasses.replace(base, kind="service",
                               per_replica_rps=float(rps),
                               base_latency_ms=float(base_ms),
                               target_p99_ms=float(target_ms))


# Serving replicas (beyond-paper; mirrors the repo's launch/serve.py stack).
# llm-serve is a single-GPU decoder replica (qwen-class model: ~40 s weight
# load, small state snapshot); embed-serve is a CPU embedding/rerank replica.
# Demands sit in Table-7 units so replicas pack into the same market.
SERVICE_WORKLOADS: tuple = (
    _sw("llm-serve", 1, 4, 24, 3, 40, rps=120, base_ms=60, target_ms=240),
    _sw("embed-serve", 0, 8, 16, 2, 20, rps=400, base_ms=25, target_ms=100,
        cpu_c=6),
)

WORKLOADS: tuple = BATCH_WORKLOADS + SERVICE_WORKLOADS

# Batch trace generators sample workload indices below NUM_BATCH_WORKLOADS,
# so pre-serving traces stay bit-identical with the extended table.
NUM_BATCH_WORKLOADS = len(BATCH_WORKLOADS)
NUM_WORKLOADS = len(WORKLOADS)
WORKLOAD_INDEX = {w.name: i for i, w in enumerate(WORKLOADS)}

# Table 1: instance-level delays (seconds).
INSTANCE_ACQUISITION_S = 19.0
INSTANCE_SETUP_S = 190.0

# Checkpoint snapshot sizes, used to price cross-region migrations (transfer
# time + egress).  Table 7 reports checkpoint *delays*; at a ~1 GB/s local
# checkpoint write bandwidth those delays double as snapshot sizes in GB
# (resnet18 ≈ 2 GB ... gpt2 ≈ 30 GB), which is the scale real checkpoints
# for these models have.
CKPT_LOCAL_WRITE_GB_PER_S = 1.0


def checkpoint_size_gb(workload: int) -> float:
    return WORKLOADS[workload].checkpoint_delay_s * CKPT_LOCAL_WRITE_GB_PER_S


def _build_interference_matrix() -> np.ndarray:
    """Ground-truth pairwise normalized throughput, modeled on Figure 1.

    M[i, j] = normalized throughput of workload i when co-located with one
    task of workload j.  Not symmetric in general (Fig. 1 is not symmetric).
    """
    rng = np.random.default_rng(20250330)  # EuroSys'25 dates, fixed seed
    # Contention intensity per workload: how much pressure it PUTS on shared
    # resources (LLC / disk / net), and sensitivity: how much it SUFFERS.
    # The ^1.5 exponent skews the matrix the way Figure 1 looks: most pairs
    # are mild (mean pairwise tput ≈ 0.95) while the worst I/O-heavy pairs
    # (graph embedding × bioinformatics) lose up to 36 %.
    #            rn2   rn4   vit   cgan  gpt2  sage  gcn   a3c   diam  foam
    pressure = [0.35, 0.35, 0.45, 0.20, 0.25, 0.75, 0.60, 0.30, 1.00, 0.55]
    # Serving replicas: memory-bandwidth pressure from KV-cache / embedding
    # reads, and high sensitivity — tail latency degrades before batch
    # throughput does.  Appended past the Table-7 block.
    pressure += [0.45, 0.55]                      # llm-serve  embed-serve
    sensitive = [0.40, 0.40, 0.35, 0.20, 0.15, 0.95, 0.70, 0.30, 0.85, 0.60]
    sensitive += [0.90, 0.80]
    # The Table-7 10x10 block must stay bit-identical to the pre-serving
    # matrix (traces and benchmarks pin decisions against it), so the base
    # block consumes the original seeded draw sequence row-major over the
    # batch workloads, and cells involving a service workload draw from a
    # separate stream.
    nb, n = NUM_BATCH_WORKLOADS, NUM_WORKLOADS
    m = np.ones((n, n))
    rng_svc = np.random.default_rng(20260807)
    for i in range(n):
        for j in range(n):
            base = 0.36 * (sensitive[i] * pressure[j]) ** 1.5
            r = rng if (i < nb and j < nb) else rng_svc
            noise = r.uniform(-0.02, 0.02)
            m[i, j] = float(np.clip(1.0 - base + noise, 0.64, 1.0))
    return m


# M_TRUE[i, j]: throughput of workload i co-located with a task of workload j.
M_TRUE = _build_interference_matrix()


def true_throughput(w: int, colocated: tuple) -> float:
    """Ground-truth normalized throughput of workload ``w`` co-located with
    the (possibly empty) multiset ``colocated`` of other workloads.  Pairwise
    effects compose multiplicatively (paper simulator §5)."""
    t = 1.0
    for w2 in colocated:
        t *= M_TRUE[w, w2]
    return float(t)
