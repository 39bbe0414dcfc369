#!/usr/bin/env python3
"""Whether Eva's simulated bill reads the order of task ids within an
assignment, on the CPU (no card, no JAX):

    PYTHONPATH=src python3 tools/pack_order.py [--jobs 40]

Runs examples/simulate_trace.py's loop through the port (``repro_torch``:
``alibaba_like_trace(jobs, seed=42, duration_model="gavel")``,
``SimConfig(seed=1)``, Eva) six times:
- on the numpy engine, as it is;
- on the port's packer (``engine="torch:cpu"``, the kernel's plain version,
  in f64), each pack also handed to the numpy engine on copies of its
  inputs: how many packs give the numpy engine's set of (type, sorted rows),
  and how many of those list the rows in another order;
- on the numpy engine with the rows sorted within each of its records;
- on the numpy engine with its records sorted by (type, rows), each
  record's rows as the engine listed them;
- on the numpy engine, its rows as listed and then sorted within each
  record, with the scheduler's ``evaluate_assignments`` (the full and the
  partial reconfiguration's savings, ``core/scheduler.py:389``) summing
  each instance's TNRP terms over its task ids in sorted order: the place
  that reads the order, so the two bills agree.
Prints each run's cost and tasks per instance, then one JSON line.  The
port's packer lists each record's rows class by class (as
``engine_jax.py``'s record expansion does), the numpy engine in the order
its greedy adds took them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=40)
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    from repro_torch.cluster import SimConfig, Simulator, alibaba_like_trace
    from repro_torch.core import EvaScheduler, aws_catalog, engine_torch
    from repro_torch.core import full_reconfig, scheduler
    cat = aws_catalog()
    real_numpy, real_torch = full_reconfig._pack_numpy, engine_torch.pack_torch
    real_eval = scheduler.evaluate_assignments

    def run(engine="numpy"):
        jobs = alibaba_like_trace(n_jobs=a.jobs, seed=42,
                                  duration_model="gavel")
        m = Simulator(cat, jobs, EvaScheduler(cat, engine=engine),
                      SimConfig(seed=1)).run()
        return {"total_cost": m.total_cost,
                "tasks_per_instance": m.summary()["tasks_per_instance"]}

    out = {"jobs": a.jobs, "numpy": run()}
    packs = {"packs": 0, "same_set": 0, "other_order": 0}

    def compared(*args, device):
        copy = list(args) + [None] * (8 - len(args))
        if copy[7] is not None:  # the packers spend the budget in place
            copy[7] = copy[7].copy()
        got = real_torch(*args, device=device)
        want = real_numpy(*copy)
        packs["packs"] += 1
        if sorted((k, sorted(r)) for k, r in got) == \
                sorted((k, sorted(r)) for k, r in want):
            packs["same_set"] += 1
            packs["other_order"] += sorted(map(tuple, got)) != \
                sorted(map(tuple, want))
        return got

    engine_torch.pack_torch = compared
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        out["torch:cpu"] = run("torch:cpu")
    finally:
        torch.set_default_dtype(prev)
        engine_torch.pack_torch = real_torch
    out["torch:cpu"].update(packs)
    for name, change in (
            ("numpy, rows sorted within records",
             lambda recs: [(k, sorted(r)) for k, r in recs]),
            ("numpy, records sorted",
             lambda recs: sorted(recs, key=lambda kr: (kr[0], sorted(kr[1]))))):
        full_reconfig._pack_numpy = \
            lambda *args, change=change: change(real_numpy(*args))
        try:
            out[name] = run()
        finally:
            full_reconfig._pack_numpy = real_numpy
    scheduler.evaluate_assignments = lambda assignments, *args, **kw: \
        real_eval([(k, tuple(sorted(t))) for k, t in assignments], *args, **kw)
    try:
        out["numpy, TNRP sums in sorted order"] = run()
        full_reconfig._pack_numpy = \
            lambda *args: [(k, sorted(r)) for k, r in real_numpy(*args)]
        out["numpy, rows sorted, TNRP sums in sorted order"] = run()
    finally:
        scheduler.evaluate_assignments = real_eval
        full_reconfig._pack_numpy = real_numpy
    for name, r in out.items():
        if name != "jobs":
            print(f"[order] {name}: {r}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
