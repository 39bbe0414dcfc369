#!/usr/bin/env python3
"""What one greedy add of the planner's packing pass costs on one NVIDIA GPU
(no JAX needed):

    python3 tools/pack_fill_parts.py [--split SOURCE] [--adds N]

- ``--split SOURCE``: SOURCE is ``kernels/pack_fill/csrc/pack_fill.cu`` or
  a copy of it.  The script builds it as it stands and a copy with
  ``clock64()`` stamps around the three parts of a greedy add, and runs
  both at 10^4 tasks (``chip_smoke.plan_fleet``, f32, interference off).
  For the warp kernel (``pack_fill_warp_kernel``; WARP_EDITS) the parts are
  the scoring of the lane's classes, the pick (the maximum, the ballot, a
  tie's redux, the winning lane) and the apply, on the single-task fleet
  (16 classes, L = 1) and the fleets of jobs of 1-8 and 1-16 tasks (128
  and 256 padded classes, at the fewest classes a lane that cover them).  For
  the one-warp shuffle variant that the source had before the warp kernel
  (``pack_fill_kernel<T, ONE_WARP>`` with ``one_warp=1``; ``git show`` of
  an older commit gives it; ONE_WARP_EDITS) they are the scoring of every
  class with its global reads, the reduction, and the apply with its
  barrier, on the single-task fleet.  It prints each part's cycles a pass
  of the add loop, its share of the kernel's cycles, and that share of the
  unstamped kernel's ns an add.  A stamp marks when the warp reached it,
  so a load issued before a stamp and first used after it is charged to
  the later part.
- Always: ``tools/pack_fill_chain.cu``, one warp running N dependent adds
  of the irreducible chain of an add without a tie, one class a lane (the
  fit test, the W-term products and sums, five shuffle rounds, one ballot,
  the winner's demand by shuffle into the next fit test; the redux runs
  only on a tie, and the data make none), in f32 and f64 at W = 0 (the pass
  with interference off skips the W term exactly) and W = 12 (the repo's
  workloads, with the winner's aggregate update); ns an add by CUDA events
  and by clock64 cycles.

Prints the card's name and power limit first and a JSON line last; exits
non-zero if a build or launch fails or an edit no longer finds its place.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "pack_fill_parts")
CHAIN_SRC = os.path.join(ROOT, "tools", "pack_fill_chain.cu")
SPLIT_N = 10_000
# (text of the one-warp source, what the stamped copy puts in its place)
ONE_WARP_EDITS = [
    ("template <class T, bool ONE_WARP>\n__global__",
     "__device__ unsigned long long pf_split[4];\n"
     "template <class T, bool ONE_WARP>\n__global__"),
    ("  const int tid = threadIdx.x, nt = blockDim.x;\n",
     "  const int tid = threadIdx.x, nt = blockDim.x;\n"
     "  const long long pf_t0 = clock64();\n"),
    ("        Cand<T> best = none<T>();\n",
     "        const long long pf_s0 = clock64();\n"
     "        Cand<T> best = none<T>();\n"),
    ("        const Cand<T> b = block_reduce<T, ONE_WARP>(best, part);\n",
     "        const long long pf_s1 = clock64();\n"
     "        const Cand<T> b = block_reduce<T, ONE_WARP>(best, part);\n"
     "        const long long pf_s2 = clock64();\n"
     "        if (tid == 0) {\n"
     "          pf_split[0] += pf_s1 - pf_s0;\n"
     "          pf_split[1] += pf_s2 - pf_s1;\n"
     "        }\n"),
    ("        ++n_add;\n        sync<ONE_WARP>();\n      }\n",
     "        ++n_add;\n        sync<ONE_WARP>();\n"
     "        if (tid == 0) pf_split[2] += clock64() - pf_s2;\n      }\n"),
    ("  if (tid == 0) {\n    stats[0] = n_rec;",
     "  if (tid == 0) pf_split[3] += clock64() - pf_t0;\n"
     "  if (tid == 0) {\n    stats[0] = n_rec;"),
]
SPLIT_TAIL = """
extern "C" int pack_fill_split(unsigned long long* host, int reset) {
  if (reset) {
    unsigned long long zero[4] = {0, 0, 0, 0};
    return (int)cudaMemcpyToSymbol(pf_split, zero, sizeof(zero));
  }
  return (int)cudaMemcpyFromSymbol(host, pf_split, sizeof(unsigned long long) * 4);
}
"""
# (part, whether it runs in the pass that ends a fill too)
ONE_WARP_PARTS = (("scoring with its global reads", True), ("reduction", True),
                  ("apply and barrier", False))
# the same for the warp kernel; each lane sums its own stamps in registers
WARP_EDITS = [
    ("template <class T, int L>\n__global__ void __launch_bounds__(32, 1) "
     "pack_fill_warp_kernel(",
     "__device__ unsigned long long pf_split[4];\n"
     "template <class T, int L>\n__global__ void __launch_bounds__(32, 1) "
     "pack_fill_warp_kernel("),
    ("  const int lane = threadIdx.x;\n",
     "  const int lane = threadIdx.x;\n"
     "  const long long pf_t0 = clock64();\n"
     "  long long pf_a0 = 0, pf_a1 = 0, pf_a2 = 0;\n"),
    ("        T fit_cap[kMaxR];\n",
     "        const long long pf_s0 = clock64();\n"
     "        T fit_cap[kMaxR];\n"),
    ("        T m = bv;\n",
     "        const long long pf_s1 = clock64();\n"
     "        pf_a0 += pf_s1 - pf_s0;\n"
     "        T m = bv;\n"),
    ("        const int src = __ffs(ballot) - 1;\n",
     "        const int src = __ffs(ballot) - 1;\n"
     "        const long long pf_s2 = clock64();\n"
     "        pf_a1 += pf_s2 - pf_s1;\n"),
    ("        ++n_add;\n      }\n",
     "        ++n_add;\n"
     "        pf_a2 += clock64() - pf_s2;\n      }\n"),
    ("  if (lane == 0) {\n    stats[0] = n_rec;",
     "  if (lane == 0) {\n"
     "    pf_split[0] += pf_a0;\n    pf_split[1] += pf_a1;\n"
     "    pf_split[2] += pf_a2;\n    pf_split[3] += clock64() - pf_t0;\n"
     "    stats[0] = n_rec;"),
]
WARP_PARTS = (("scoring", True), ("pick", False), ("apply", False))


def nvcc_build(src: str, out: str) -> str:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", out, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stdout}")
    return proc.stdout


def stamped(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"the edit no longer finds its place: {old!r}")
        text = text.replace(old, new)
    return text + SPLIT_TAIL


def split(source: str, device) -> dict:
    """The add of ``source`` split into its parts (see the docstring)."""
    import torch
    import chip_smoke as smoke
    from repro_torch.core import aws_catalog
    from repro_torch.kernels.pack_fill.kernel import PER_LANE
    with open(source) as f:
        text = f.read()
    warp = "pack_fill_warp_kernel" in text
    edits, parts = (WARP_EDITS, WARP_PARTS) if warp else \
        (ONE_WARP_EDITS, ONE_WARP_PARTS)
    paths = {}
    for name, body in (("plain", text), ("stamped", stamped(text, edits))):
        src = os.path.join(OUT, f"split_{name}.cu")
        with open(src, "w") as f:
            f.write(body)
        paths[name] = os.path.join(OUT, f"libsplit_{name}.so")
        log = nvcc_build(src, paths[name])
        for ln in smoke.ptxas_summary(log):
            print(f"[build] split {name}: {ln}")
    cat = aws_catalog()
    fleets = smoke.PLAN_FLEETS if warp else {"single-task": (1,)}
    out = {}
    for fleet, sizes in fleets.items():
        inputs, max_fills = smoke.plan_inputs(
            smoke.plan_fleet(SPLIT_N, job_sizes=sizes), cat, device)
        args = inputs.args
        C, F, R = args[0].shape
        W, K, M, NR = args[6].shape[0], args[8].shape[0], args[5].shape[1], \
            args[12].numel()
        # the warp kernel: the fewest classes a lane that cover C
        launch = (next(L for L in PER_LANE if 32 * L >= C), 32) if warp \
            else (32, 1)  # (per_lane, threads) or (threads, one_warp)
        outs = [torch.empty_like(args[12]),
                torch.empty(max_fills, dtype=torch.int32, device=device),
                torch.empty(max_fills, dtype=torch.int32, device=device),
                torch.empty(max_fills, C, dtype=torch.int32, device=device),
                torch.empty(4, dtype=torch.int64, device=device)]
        res = {"n_tasks": SPLIT_N, "classes": C, "launch": launch}
        for name, path in paths.items():
            lib = ctypes.CDLL(path)
            lib.pack_fill.argtypes = ([ctypes.c_void_p] * 13
                                      + [ctypes.c_int] * 11
                                      + [ctypes.c_void_p] * 7)

            def run():
                err = lib.pack_fill(
                    *(a.data_ptr() for a in args), C, F, R, M, W, K, NR,
                    max_fills, 0, *launch, *(t.data_ptr() for t in outs),
                    None, torch.cuda.current_stream(device).cuda_stream)
                if err:
                    raise SystemExit(f"launch failed with CUDA error {err}")

            ms = smoke.time_ms(run, 10, warmup=2)
            adds, fills = outs[4].tolist()[2:]
            res[f"{name}_ms"] = ms
            res[f"{name}_ns_per_add"] = ms * 1e6 / adds
            res["adds"], res["fills"] = adds, fills
            if name == "stamped":
                lib.pack_fill_split.argtypes = [ctypes.c_void_p, ctypes.c_int]
                host = (ctypes.c_ulonglong * 4)()
                assert lib.pack_fill_split(host, 1) == 0
                run()
                torch.cuda.synchronize(device)
                assert lib.pack_fill_split(host, 0) == 0
                cyc = list(host)
                total = cyc[3]
                res["stamped_cycles"] = total
                res["stamped_ghz"] = total / (ms * 1e6)
                res["parts"] = {
                    part: {"cycles_per_pass":
                           c / (adds + fills if every_pass else adds),
                           "share": c / total,
                           "ns_per_add_of_plain":
                               c / total * res["plain_ns_per_add"]}
                    for (part, every_pass), c in zip(parts, cyc)}
                res["parts"]["outside the add loop"] = {
                    "share": 1 - sum(cyc[:3]) / total}
        print(f"[split] {fleet}: {json.dumps(res)}")
        out[fleet] = res
    return out


def chain_inputs(W: int, dtype, gen):
    """``pack_fill_chain``'s values: P in [0.7, 1), RPs in [0.5, 1) with
    each lane's penalty above its RP but lane 5's equal to it (so lane 5
    wins every add with a score of exactly 0), demands in [0, 1) and job RP
    x throughput below 1e-25 (so the W-term sum stays far below an RP's
    rounding, and the score at 0)."""
    import torch
    P = 0.7 + 0.3 * torch.rand(W * W, generator=gen, dtype=dtype)
    crp = 0.5 + 0.5 * torch.rand(32, generator=gen, dtype=dtype)
    pen = crp + 0.01 + 0.09 * torch.rand(32, generator=gen, dtype=dtype)
    pen[5] = crp[5]
    d = torch.rand(3 * 32, generator=gen, dtype=dtype)
    ctp = 1e-25 * torch.rand(32, generator=gen, dtype=dtype)
    return torch.cat([P, crp, pen, d, ctp, torch.zeros(W, dtype=dtype)])


def chain(adds: int, device) -> dict:
    """tools/pack_fill_chain.cu's ns an add (see the docstring)."""
    import torch
    import chip_smoke as smoke
    path = os.path.join(OUT, "libpack_fill_chain.so")
    for ln in smoke.ptxas_summary(nvcc_build(CHAIN_SRC, path)):
        print(f"[build] chain: {ln}")
    lib = ctypes.CDLL(path)
    lib.pack_fill_chain.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_double,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p]
    gen = torch.Generator().manual_seed(0)
    keys = torch.randperm(1 << 20, generator=gen)[:32].int().to(device)
    out = {}
    for dtype in (torch.float32, torch.float64):
        res = torch.empty(2, dtype=dtype, device=device)
        cycles = torch.zeros(1, dtype=torch.int64, device=device)
        for w in (0, 12):
            vals = chain_inputs(w, dtype, gen).to(device)

            def run():
                err = lib.pack_fill_chain(
                    vals.data_ptr(), keys.data_ptr(), adds, 1e30,
                    int(dtype == torch.float64), w, res.data_ptr(),
                    cycles.data_ptr(),
                    torch.cuda.current_stream(device).cuda_stream)
                if err:
                    raise SystemExit(f"chain launch failed: CUDA error {err}")

            ms = smoke.time_ms(run, 5, warmup=1)
            last, done = res.tolist()
            if done != adds or last != 0:
                raise SystemExit(f"the chain ran {done} of {adds} adds and "
                                 f"ended at {last}, not 0")
            key = f"{str(dtype).split('.')[1]} W={w}"
            out[key] = {"ns_per_add": ms * 1e6 / adds,
                        "cycles_per_add": int(cycles.item()) / adds}
            print(f"[chain] {key}: {out[key]}")
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--split", metavar="SOURCE")
    ap.add_argument("--adds", type=int, default=1 << 20)
    a = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    os.makedirs(OUT, exist_ok=True)
    device = torch.device("cuda", 0)
    print(f"[card] {smoke.card_line()}")
    result = {"card": smoke.card_line()}
    if a.split:
        result["split"] = split(a.split, device)
    result["chain"] = chain(a.adds, device)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
