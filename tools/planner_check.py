#!/usr/bin/env python3
"""``chip_smoke.py``'s planner phases alone, on one NVIDIA GPU (no JAX
needed): the packing kernel (``kernels/pack_fill``) against the numpy
engine and its plain version, the warp and block kernels' times at
10^3-10^6 tasks of each fleet of ``chip_smoke.PLAN_FLEETS`` (single-task,
jobs of 1-8 and of 1-16 tasks) in f32 and f64, and the 400-job trace-driven simulation with Eva on the kernel; then
the kernels line's ``pack_fill`` entry as JSON.

    python3 tools/planner_check.py [--ssd]

``--ssd`` also runs the smoke's SSD backward phase (its f32 dA at the
physical mode's shape held against float64).  Exits non-zero if a kernel
fails to build or launch or a gate fails.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch.kernels import build
    logs = build.build_all()
    for ln in smoke.ptxas_summary(logs["pack_fill"]):
        print(f"[build] pack_fill: {ln}")
    device = torch.device("cuda", 0)
    print(f"[card] {smoke.card_line()}")
    try:
        errs = smoke.planner_vs_plain(device)
        times = smoke.planner_timing(device)
        sim = smoke.planner_simulation(device)
        if "--ssd" in argv:
            smoke.ssd_bwd_vs_plain(device)
    except smoke.SmokeFailure as e:
        print(f"planner_check: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps(smoke.planner_entry(errs, times, sim)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
