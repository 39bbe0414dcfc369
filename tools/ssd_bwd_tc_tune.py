#!/usr/bin/env python3
"""Time the bf16 ``ssd_bwd_chunk`` (``csrc/ssd_bwd_tc.cu``, the tensor-core
kernel) at mamba2-780m's training shape on one NVIDIA GPU (no JAX needed):

    python3 tools/ssd_bwd_tc_tune.py [--source PATH] [--head-blocks 3,6,12]

Builds copies of the source under build/ssd_bwd_tc_tune/ with the port's
nvcc flags, all at once, and prints each copy's registers, shared memory and
spills as ptxas reports them.  The checked-in copy is first held against
``chunk_bwd_ref`` at that shape (TOL of each gradient's largest magnitude,
dA of its terms', as ``tests/test_torch_cuda.py``); then
- head blocks: the checked-in copy at every head block of ``--head-blocks``
  (the heads a block walks; the wrapper passes ``BWD_TC_HEAD_BLOCK``);
- parts: copies with one part of the kernel switched off (PARTS), timed at
  the checked-in head block in turns with the whole kernel.  A copy computes
  wrong gradients; what it measures is the time the part costs where it
  stands.
Every time is a CUDA-event mean over 10 launches after 2, in two rounds
(ascending, then descending), without PyTorch's sums of the partials.  It
exits non-zero if a build fails, an edit no longer finds its place in the
source or the check fails.  ``--source`` takes another copy of
``ssd_bwd_tc.cu`` in the checked-in one's place (a design to compare).
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src/repro_torch/kernels/ssd_scan/csrc/ssd_bwd_tc.cu")
OUT = os.path.join(ROOT, "build", "ssd_bwd_tc_tune")
SHAPE = (4, 2048, 48, 64, 1, 128, 256)  # (Bt, S, H, P, G, N, chunk)
HEAD_BLOCKS = (2, 3, 4, 6, 8, 12)
# max|err| / scale by gradient: dx is written in bf16; the f32 ddt, dB, dC
# and dD meet 1e-4 only with the hi + lo split of the f32 operands; dA's
# cancelling terms put its f32 rounding floor near 1e-4 (tests/test_torch_cuda.py)
TOL = {"dx": 2e-2, "ddt": 1e-4, "dA": 1e-3, "dB": 1e-4, "dC": 1e-4, "dD": 1e-4}
# part -> (text in ssd_bwd_chunk_tc_kernel, the text that switches it off)
PARTS = {
    "the key rounds' intra term (query strips i >= j)": (
        "for (int i = strip; i < ns; ++i) {", "for (int i = ns; i < ns; ++i) {"),
    "the key rounds' chunk-input terms (B Dc^T, x Dc)": (
        "for (int pp = 0; pp < P / 16; ++pp) {\n          float u[2][4];",
        "for (int pp = P; pp < P / 16; ++pp) {\n          float u[2][4];"),
    "the query rounds' intra term (key strips j <= i)": (
        "for (int j = 0; j <= strip; ++j) {", "for (int j = 0; j < 0; ++j) {"),
    "the query rounds' carry (dy h_in^T)": (
        "for (int nn = 0; nn < N / 16; ++nn) {\n          float y[2][4];",
        "for (int nn = N; nn < N / 16; ++nn) {\n          float y[2][4];"),
    "the reverse cumsum": (
        "if ((int)threadIdx.x < nh) {", "if ((int)threadIdx.x < 0) {"),
}


def variants(src: str) -> dict:
    text = open(src).read()
    out = {"checked in": text}
    for part, (old, new) in PARTS.items():
        if text.count(old) != 1:
            raise SystemExit(f"the edit for {part!r} no longer finds its place in {src}")
        out[f"without {part}"] = text.replace(old, new)
    return out


def build(job):
    from repro_torch.kernels import build as kb
    i, text = job
    d = os.path.join(OUT, str(i))
    os.makedirs(d, exist_ok=True)
    src, lib = os.path.join(d, "ssd_bwd_tc.cu"), os.path.join(d, "libssd_bwd_tc.so")
    with open(src, "w") as f:
        f.write(text)
    # the copy includes the checked-in source's header (ssd_common.cuh)
    proc = subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-I", os.path.dirname(SRC),
                           "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on variant {i}:\n{proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def report(log: str) -> list:
    """ssd_bwd_chunk_tc_kernel's registers, shared memory and spills, one
    line a (P, N)."""
    lines, entry, spills = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"ssd_bwd_chunk_tc_kernelILi(\d+)ELi(\d+)E+v", ln)
            entry = m.groups() if m else None
        elif entry and "spill stores" in ln:
            spills = ln.strip()
        elif entry and "Used" in ln:
            lines.append(f"(P {entry[0]}, N {entry[1]}) {ln.split(':', 1)[1].strip()}; "
                         f"{spills}")
            entry = None
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=SRC)
    ap.add_argument("--head-blocks", default=",".join(map(str, HEAD_BLOCKS)))
    args = ap.parse_args(argv)
    head_blocks = [int(v) for v in args.head_blocks.split(",")]
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_tc_tune: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.ssd_scan.kernel import BWD_TC_HEAD_BLOCK
    from repro_torch.kernels.ssd_scan.ref import (chunk_bwd_ref, chunk_cumsum,
                                                  pass_states, ssd_chunk_ref)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"[source] {args.source}")
    named = variants(args.source)
    with ThreadPoolExecutor(len(named)) as pool:
        built = dict(zip(named, pool.map(build, enumerate(named.values()))))
    for name, (_, log) in built.items():
        for ln in report(log):
            print(f"[build] {name}: {ln}")

    device = torch.device("cuda", 0)
    Bt, S, H, P, G, N, chunk = SHAPE
    nc = S // chunk
    g = torch.Generator(device).manual_seed(0)
    bf = torch.bfloat16
    x = torch.randn(Bt, S, H, P, generator=g, device=device).to(bf)
    dt = 0.1 + 0.8 * torch.rand(Bt, S, H, generator=g, device=device)
    A = -torch.linspace(1.0, 16.0, H, device=device)
    B = torch.randn(Bt, S, G, N, generator=g, device=device).to(bf)
    C = torch.randn(Bt, S, G, N, generator=g, device=device).to(bf)
    D = torch.randn(H, generator=g, device=device)
    dy = torch.randn(Bt, S, H, P, generator=g, device=device).to(bf)
    cum = chunk_cumsum(dt, A, chunk)
    _, cin = ssd_chunk_ref(x, dt, cum, B, C, chunk=chunk)
    h_ins, _ = pass_states(cin, torch.exp(cum[:, chunk - 1::chunk]))
    dci = torch.randn(h_ins.shape, generator=g, device=device)
    end = torch.randn(Bt, nc, H, generator=g, device=device)
    ins = (x, dt, A, cum, B, C, D, dy, h_ins, dci, end)

    def runner(lib, hb):
        fn = ctypes.CDLL(lib).ssd_bwd_chunk_tc
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        nhb = -(-(H // G) // hb)
        outs = (torch.empty_like(x), torch.empty_like(dt),
                torch.empty(nhb, Bt, S, G, N, device=device),
                torch.empty(nhb, Bt, S, G, N, device=device),
                torch.empty(Bt, nc, H, device=device), torch.empty(Bt, nc, H, device=device))
        ptrs = [t.data_ptr() for t in (*ins, *outs)]
        stream = torch.cuda.current_stream(device).cuda_stream

        def run():
            err = fn(*ptrs, Bt, S, H, G, P, N, chunk, hb, stream)
            if err:
                raise SystemExit(f"launch failed with CUDA error {err}")
            return outs
        return run

    dx, ddt, dBp, dCp, dAp, dDp = runner(built["checked in"][0], BWD_TC_HEAD_BLOCK)()
    torch.cuda.synchronize(device)
    *ref, dA_scale = chunk_bwd_ref(*ins, chunk=chunk, dA_scale=True)
    got = (dx, ddt, dAp.sum((0, 1)), dBp.sum(0), dCp.sum(0), dDp.sum((0, 1)))
    errs = {}
    for what, a, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, ref):
        d = (a.float() - r.float()).abs()
        scale = dA_scale if what == "dA" else r.float().abs().max()
        errs[what] = (d / scale).max().item()
    print("[check] checked in vs chunk_bwd_ref, max|err| / scale: "
          + ", ".join(f"{k} {v:.3e} (tol {TOL[k]:g})" for k, v in errs.items()))
    if not all(v <= TOL[k] for k, v in errs.items()):
        print("ssd_bwd_tc_tune: the checked-in kernel disagrees with its plain "
              "version", file=sys.stderr)
        return 1
    del got, ref

    def time_ms(run) -> float:
        for _ in range(2):
            run()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(10):
            run()
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop) / 10

    jobs = [("checked in", hb) for hb in head_blocks]
    jobs += [(name, BWD_TC_HEAD_BLOCK) for name in named if name.startswith("without")]
    runs = {job: runner(built[job[0]][0], job[1]) for job in jobs}
    times = {job: [] for job in jobs}
    for order in (jobs, jobs[::-1]):
        for job in order:
            times[job].append(time_ms(runs[job]))
    for (name, hb), ms in times.items():
        print(f"[time] ssd_bwd_chunk_tc {name}, head block {hb}: "
              f"{ms[0]:.4f} / {ms[1]:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
