#!/usr/bin/env python3
"""Time the port's SSD backward kernels (``ssd_bwd.cu``) at mamba2-780m's
training shape on one NVIDIA GPU (no JAX needed):

    python3 tools/ssd_bwd_tune.py [--source PATH]

Builds copies of the source under build/ssd_bwd_tune/ with the port's nvcc
flags, all at once, and prints each copy's registers and spills as ptxas
reports them:
- launch bounds: ``ssd_bwd_chunk_kernel``'s ``__launch_bounds__`` as checked
  in and as LAUNCH_BOUNDS lists, each timed at every head block in
  HEAD_BLOCKS (the heads a block walks; the wrapper passes
  ``BWD_HEAD_BLOCK``), bf16 and f32;
- parts: copies with one part of ``ssd_bwd_chunk`` switched off (PARTS),
  timed at the checked-in head block in turns with the whole kernel.  A copy
  computes wrong gradients; what it measures is the time the part costs
  where it stands.
Every time is a CUDA-event mean over 10 launches after 2, in two rounds
(ascending, then descending).  It exits non-zero if a build fails or an
edit no longer finds its place in the source.  ``--source`` takes another
copy of ``ssd_bwd.cu`` in the checked-in one's place (a design to compare).
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
SRC = os.path.join(ROOT, "src/repro_torch/kernels/ssd_scan/csrc/ssd_bwd.cu")
OUT = os.path.join(ROOT, "build", "ssd_bwd_tune")
SHAPE = (4, 2048, 48, 64, 1, 128, 256)  # (Bt, S, H, P, G, N, chunk)
HEAD_BLOCKS = (1, 2, 3, 4)
BOUNDS_AT = "__global__ void __launch_bounds__(THREADS, 2)\nssd_bwd_chunk_kernel("
LAUNCH_BOUNDS = ("(THREADS)", "(THREADS, 1)")
# part -> (text in ssd_bwd_chunk_kernel, the text that switches it off)
PARTS = {
    "the intra term (query tiles i >= j)": (
        "    for (int i = j; i < nt; ++i) {", "    for (int i = nt; i < nt; ++i) {"),
    "the chunk input's and the carry's terms": (
        "    for (int hh = 0; hh < nh; ++hh) {\n      const int h = h_first + hh;\n"
        "      load_rows(sX",
        "    for (int hh = 0; hh < 0; ++hh) {\n      const int h = h_first + hh;\n"
        "      load_rows(sX"),
    "the reverse cumsum and ddt's write": (
        "  if (tid < nh) {\n    const int hh = tid, h = h_first + hh;",
        "  if (tid < 0) {\n    const int hh = tid, h = h_first + hh;"),
}


def variants(src: str) -> dict:
    text = open(src).read()
    if text.count(BOUNDS_AT) != 1:
        raise SystemExit(f"the launch bounds no longer find their place in {src}")
    out = {"checked in": text}
    for bounds in LAUNCH_BOUNDS:
        out[f"launch bounds {bounds}"] = text.replace(
            BOUNDS_AT, BOUNDS_AT.replace("(THREADS, 2)", bounds))
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
    src, lib = os.path.join(d, "ssd_bwd.cu"), os.path.join(d, "libssd_bwd.so")
    with open(src, "w") as f:
        f.write(text)
    proc = subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on variant {i}:\n{proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def chunk_report(log: str) -> list:
    """ssd_bwd_chunk_kernel's registers and spills, one line a (P, N, type)."""
    lines, entry = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"ssd_bwd_chunk_kernelILi(\d+)ELi(\d+)E(\w+?)EEv", ln)
            entry = m.groups() if m else None
        elif entry and "spill stores" in ln:
            spills = ln.strip()
        elif entry and "Used" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            kind = "bf16" if "bfloat16" in entry[2] else "f32"
            lines.append(f"(P {entry[0]}, N {entry[1]}, {kind}) {regs} registers; {spills}")
            entry = None
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=SRC)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("ssd_bwd_tune: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels.ssd_scan.kernel import BWD_HEAD_BLOCK
    from repro_torch.kernels.ssd_scan.ref import (chunk_cumsum, pass_states,
                                                  ssd_chunk_ref)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"[source] {args.source}")
    named = variants(args.source)
    with ThreadPoolExecutor(len(named)) as pool:
        built = dict(zip(named, pool.map(build, enumerate(named.values()))))
    for name, (_, log) in built.items():
        for ln in chunk_report(log):
            print(f"[build] {name}: {ln}")

    device = torch.device("cuda", 0)
    Bt, S, H, P, G, N, chunk = SHAPE
    nc = S // chunk
    g = torch.Generator(device).manual_seed(0)
    inputs = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(Bt, S, H, P, generator=g, device=device).to(dtype)
        dt = 0.1 + 0.8 * torch.rand(Bt, S, H, generator=g, device=device)
        A = -torch.linspace(1.0, 16.0, H, device=device)
        B = torch.randn(Bt, S, G, N, generator=g, device=device).to(dtype)
        C = torch.randn(Bt, S, G, N, generator=g, device=device).to(dtype)
        D = torch.randn(H, generator=g, device=device)
        dy = torch.randn(Bt, S, H, P, generator=g, device=device).to(dtype)
        cum = chunk_cumsum(dt, A, chunk)
        _, cin = ssd_chunk_ref(x, dt, cum, B, C, chunk=chunk)
        h_ins, _ = pass_states(cin, torch.exp(cum[:, chunk - 1::chunk]))
        dci = torch.randn(h_ins.shape, generator=g, device=device)
        end = torch.randn(Bt, nc, H, generator=g, device=device)
        inputs[dtype] = (x, dt, A, cum, B, C, D, dy, h_ins, dci, end)

    def timer(lib, dtype, hb):
        fn = ctypes.CDLL(lib).ssd_bwd_chunk
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        x, dt, A, cum, B, C, D, dy, h_ins, dci, end = inputs[dtype]
        nhb = -(-(H // G) // hb)
        outs = (torch.empty_like(x), torch.empty_like(dt),
                torch.zeros(nhb, Bt, S, G, N, device=device),
                torch.zeros(nhb, Bt, S, G, N, device=device),
                torch.empty(Bt, nc, H, device=device), torch.empty(Bt, nc, H, device=device))
        args = [t.data_ptr() for t in (x, dt, A, cum, B, C, D, dy, h_ins, dci, end, *outs)]
        stream = torch.cuda.current_stream(device).cuda_stream

        def run():
            err = fn(*args, Bt, S, H, G, P, N, chunk, hb, int(dtype == torch.bfloat16),
                     stream)
            if err:
                raise SystemExit(f"launch failed with CUDA error {err}")
        return run

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

    jobs = [(name, dtype, hb) for name in ["checked in"] + [f"launch bounds {b}"
                                                           for b in LAUNCH_BOUNDS]
            for dtype in (torch.bfloat16, torch.float32) for hb in HEAD_BLOCKS]
    jobs += [(name, torch.bfloat16, BWD_HEAD_BLOCK) for name in named
             if name.startswith("without")]
    runs = {job: timer(built[job[0]][0], *job[1:]) for job in jobs}
    times = {job: [] for job in jobs}
    for order in (jobs, jobs[::-1]):
        for job in order:
            times[job].append(time_ms(runs[job]))
    for (name, dtype, hb), ms in times.items():
        print(f"[time] ssd_bwd_chunk {name}, {str(dtype)[6:]}, head block {hb}: "
              f"{ms[0]:.4f} / {ms[1]:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
