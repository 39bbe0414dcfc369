"""Small fleets on which ``tests/test_torch_cuda_emu.py`` (the emulated
kernel) and ``tests/test_torch_cuda.py`` (the kernel on the card) hold the
packing pass ``csrc/pack_fill.cu`` against its plain version,
``pack_all_types_ref``.  Imports nothing of JAX or the JAX package."""
import numpy as np
import torch

from repro_torch.core import (TaskSet, ThroughputTable, aws_catalog,
                              dispersed_demo_regions, job_rp_sums, make_task,
                              multi_region_catalog, reservation_prices)
from repro_torch.core.engine_torch import pass_inputs
from repro_torch.core.workloads import NUM_WORKLOADS

# (case, record buffer): the last one overflows
PACK_CASES = [("plain", 64), ("interference", 64), ("mask", 64),
              ("region", 64), ("many", 512), ("interference", 3)]


def pack_case(case, dtype):
    """The packing pass's inputs of a small fleet (60 tasks of jobs of 1–3
    tasks, so that per-job RP sums vary), through ``pass_inputs`` on the CPU
    in ``dtype``: "plain" (no interference), "interference" (a seeded
    throughput table), "mask" (the GPU family masked out, CPU tasks only),
    "region" (three regions with budgets of 3, 4 and any number of
    instances; at that hour the second region is the cheapest) or "many"
    (66 jobs of 1–8 tasks, each a distinct pair of workload and size, and
    the seeded table: 66 classes, more than 64, so that the warp kernel
    runs four or eight classes a lane)."""
    rng = np.random.default_rng(61)
    cat = multi_region_catalog(dispersed_demo_regions(3)).at(3600.0) \
        if case == "region" else aws_catalog()
    mask = np.array([t.family != "p3" for t in cat.types]) \
        if case == "mask" else None
    pool = list(range(NUM_WORKLOADS))
    if case == "mask":  # the workloads that fit a CPU type
        pool = [w for w in pool if fits_masked(cat, mask, w)]
    tasks, j = [], 0
    if case == "many":
        for j, pair in enumerate(rng.permutation(NUM_WORKLOADS * 8)[:66]):
            w, size = int(pair) % NUM_WORKLOADS, int(pair) // NUM_WORKLOADS + 1
            tasks += [make_task(j, w, task_id=len(tasks) + i)
                      for i in range(size)]
    while len(tasks) < 60:
        w = int(rng.choice(pool))
        tasks += [make_task(j, w, task_id=len(tasks) + i)
                  for i in range(int(rng.integers(1, 4)))]
        j += 1
    ts = TaskSet(tasks)
    rp = reservation_prices(ts, cat, type_mask=mask)
    pairwise = np.ones((NUM_WORKLOADS, NUM_WORKLOADS))
    if case in ("interference", "many"):
        table = ThroughputTable(NUM_WORKLOADS, default=0.95)
        for _ in range(25):
            w1, w2 = rng.integers(NUM_WORKLOADS, size=2)
            table.record(int(w1), (int(w2),), float(rng.uniform(0.7, 1.0)))
        pairwise = table.pairwise_matrix()
    budget = np.array([3, 4, 2 ** 40]) if case == "region" else None
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dtype)
    try:
        return pass_inputs(ts.demand_by_family, ts.workloads, rp,
                           job_rp_sums(ts, rp), cat, pairwise, mask, budget,
                           device="cpu").args
    finally:
        torch.set_default_dtype(prev)


def fits_masked(cat, mask, w):
    """Whether a task of workload ``w`` fits a type that ``mask`` keeps."""
    try:
        reservation_prices(TaskSet([make_task(0, w, task_id=0)]), cat,
                           type_mask=mask)
    except ValueError:  # fits no unmasked type
        return False
    return True
