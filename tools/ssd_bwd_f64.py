#!/usr/bin/env python3
"""How far the f32 SSD backward chunk kernel (``ssd_bwd.cu``'s
``ssd_bwd_chunk``) and its f32 plain version (``chunk_bwd_ref``) each lie
from a float64 evaluation of the same formulas, on one NVIDIA GPU (no JAX
needed):

    python3 tools/ssd_bwd_f64.py

For each case of ``chip_smoke.py``'s SSD backward phase at the shapes below
(the same inputs: ``ssd_bwd_case`` with seed 800 + the shape's index in
that phase's list), the kernel pipeline (ssd_bwd_dstate, ssd_bwd_state_pass,
ssd_bwd_chunk) runs on f32 inputs on the card; ``chunk_bwd_ref`` then runs
from the kernel's dchunk_in and chunk-end term twice: in f32 on the card
(the plain version the smoke's gate holds the kernel to) and in float64 on
the CPU (its ``.float()`` casts kept at float64).  Each gradient's distance
is printed relative to the gate's scale: dA to the sum of its terms'
magnitudes (``dA_scale``, per head), the others to the float64 gradient's
largest magnitude.  Also printed: whether the smoke's f32 gate (1e-4 abs +
1e-4 of that scale, kernel against plain) would pass.  Exits non-zero only
if a kernel fails to build or launch.
"""
from __future__ import annotations

import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD")


@contextlib.contextmanager
def float_keeps_double():
    """``Tensor.float()`` leaves a float64 tensor float64, so that a plain
    version written with f32 casts evaluates its formulas in float64."""
    import torch
    cast = torch.Tensor.float
    torch.Tensor.float = lambda t, *a, **k: (
        t if t.dtype == torch.float64 else cast(t, *a, **k))
    try:
        yield
    finally:
        torch.Tensor.float = cast


def main() -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from repro_torch.kernels.ssd_scan.kernel import (ssd_bwd_chunk,
                                                     ssd_bwd_dstate,
                                                     ssd_bwd_state_pass)
    from repro_torch.kernels.ssd_scan.ref import chunk_bwd_ref
    device = torch.device("cuda")
    shapes = smoke.SSD_BWD_GRID + [smoke.CLUSTER_SSD]
    tol = smoke.SSD_BWD_TOL["float32"]
    rows = []
    for i, shape in enumerate(shapes):
        if shape not in (smoke.CLUSTER_SSD, smoke.SSD_BWD_GRID[-1]):
            continue  # the physical mode's shape and the training shape
        combos = ((True, True), (False, False)) if shape[1] >= 2048 else \
            ((True, True), (True, False), (False, True), (False, False))
        for with_h0, with_dhf in combos:
            x, dt, A, B, C, D, cum, h_ins, dy, dhf = smoke.ssd_bwd_case(
                shape, torch.float32, device, 800 + i, with_h0, with_dhf)
            chunk = shape[6]
            dS = ssd_bwd_dstate(dy, cum, C, chunk=chunk)
            dchunk_in, _, end = ssd_bwd_state_pass(dS, cum, h_ins, dhf,
                                                   chunk=chunk)
            args = (x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in, end)
            kern = ssd_bwd_chunk(*args, chunk=chunk)
            plain = chunk_bwd_ref(*args, chunk=chunk)
            with float_keeps_double():
                *f64, scale = chunk_bwd_ref(
                    *(a.detach().cpu().double() for a in args), chunk=chunk,
                    dA_scale=True)
            torch.cuda.synchronize(device)
            row = {"shape": list(shape[:7]), "seed": 800 + i, "h0": with_h0,
                   "dh_final": with_dhf,
                   "dA_scale_min": scale.min().item(),
                   "dA_scale_max": scale.max().item()}
            for w, k, p, r in zip(GRADS, kern, plain, f64):
                k, p = k.double().cpu(), p.double().cpu()
                s = scale if w == "dA" else r.abs().max()
                row[w] = {
                    "kernel_vs_f64": ((k - r).abs() / s).max().item(),
                    "plain_vs_f64": ((p - r).abs() / s).max().item(),
                    "kernel_vs_plain": ((k - p).abs() / s).max().item(),
                    "kernel_vs_plain_abs": (k - p).abs().max().item(),
                    "gate_passes": bool(((k - p).abs() - tol - tol * s).max()
                                        <= 0)}
            rows.append(row)
            print(f"(Bt,S,H,P,G,N,chunk)={tuple(shape[:7])} seed {800 + i} "
                  f"h0={with_h0} dh_final={with_dhf}: dA_scale "
                  f"{row['dA_scale_min']:.4e}..{row['dA_scale_max']:.4e}; "
                  + "; ".join(
                      f"{w} kernel {row[w]['kernel_vs_f64']:.3e} plain "
                      f"{row[w]['plain_vs_f64']:.3e} from f64, apart "
                      f"{row[w]['kernel_vs_plain']:.3e} "
                      f"({row[w]['kernel_vs_plain_abs']:.3e} abs, gate "
                      f"{'passes' if row[w]['gate_passes'] else 'FAILS'})"
                      for w in GRADS))
    print(json.dumps({"ssd_bwd_f64": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
