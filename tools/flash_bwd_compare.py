#!/usr/bin/env python3
"""Check and time the bf16 flash backward's dK/dV and dQ kernels at
head_dim 16 and 64 on one NVIDIA GPU (no JAX needed):

    python3 tools/flash_bwd_compare.py [--source DIR ...] [--iters 20]

Builds the checked-in ``csrc/flash_attn_bwd.cu`` and the copy in each
``--source`` directory (its ``flash_attn_bwd.cu`` with its own
``flash_common.cuh`` beside it, say an earlier commit's, unpacked with
``git archive``) under ``build/flash_bwd_compare/`` with the port's nvcc
flags, all at once, and prints each build's registers, shared memory and
spills of the bf16 dK/dV and dQ kernels as ptxas reports them.  Then:
- the checked-in build's warpgroup products (``flash_attn_bwd_wgmma_probe``:
  both swizzles, K-major and MN-major B) against ``torch.matmul``;
- every build's three kernels against ``attention_bwd_ref`` (bf16 2e-2
  abs + rel, as ``chip_smoke.py``) at CHECKS, and the checked-in build's
  outputs of two launches to the bit;
- dK/dV and dQ of every build at TIMED (the four training shapes and the
  physical mode's two), CUDA events over ``--iters`` launches after 3, in
  two rounds (the builds in order, then reversed), each beside its bound
  (``chip_smoke.attention_bwd_bounds``) and SDPA's backward alone.
It exits non-zero if a build fails or a check disagrees.  The card's name
and power limit head the output.
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
CSRC = os.path.join(ROOT, "src/repro_torch/kernels/flash_attention/csrc")
OUT = os.path.join(ROOT, "build", "flash_bwd_compare")
TOL = 2e-2
# (B, S, H, KH, hd, window, causal)
TIMED = {
    "qwen3-0.6b": (4, 2048, 16, 8, 64, None, True),
    "granite-moe-3b-a800m": (4, 2048, 24, 8, 64, None, True),
    "whisper-medium decoder": (4, 2048, 16, 16, 64, None, True),
    "whisper-medium encoder": (4, 1500, 16, 16, 64, None, False),
    "physical mode (smollm-135m)": (2, 32, 9, 3, 64, None, True),
    "physical mode (qwen3-0.6b)": (2, 32, 16, 8, 64, None, True),
}
CHECKS = list(TIMED.values()) + [
    (2, 129, 4, 4, 16, None, True), (1, 65, 2, 1, 16, 1, True),
    (1, 70, 3, 1, 16, None, False), (2, 129, 4, 2, 64, 40, True),
    (1, 2049, 2, 1, 64, 300, True), (1, 200, 6, 2, 64, None, True),
    (1, 1, 2, 1, 64, None, True), (2, 15, 4, 4, 64, None, True),
    (1, 65, 2, 2, 64, None, False), (1, 127, 4, 2, 64, 1, True),
]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def build(job):
    from repro_torch.kernels import build as kb
    i, src_dir = job
    d = os.path.join(OUT, str(i))
    os.makedirs(d, exist_ok=True)
    lib = os.path.join(d, "libflash_attn_bwd.so")
    proc = subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-I", src_dir, "-o", lib,
                           os.path.join(src_dir, "flash_attn_bwd.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src_dir}:\n{proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def report(log: str) -> list:
    """The bf16 hd-16 and hd-64 dK/dV and dQ kernels' lines of ptxas's
    report: registers, shared memory and spills."""
    lines, entry, spills = [], None, ""
    for ln in log.splitlines():
        if "Performance" in ln:  # ptxas's warnings (wgmma serialized)
            lines.append(ln.strip())
        if "Compiling entry function" in ln:
            m = re.search(r"flash_attn_bwd_(dkdv|dq)_(tc|wg)_kernelILi(\d+)E", ln)
            entry = m.groups() if m else None
        elif entry and "spill stores" in ln:
            spills = ln.strip()
        elif entry and "Used" in ln:
            lines.append(f"{entry[0]}_{entry[1]}<{entry[2]}>: "
                         f"{ln.split(':', 1)[1].strip()}; {spills}")
            entry = None
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    help="a directory holding another flash_attn_bwd.cu and "
                         "its flash_common.cuh")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_bwd_compare: needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import attention_bwd_bounds, qkv
    from repro_torch.kernels import build as kb
    from repro_torch.kernels.flash_attention.kernel import (
        BWD_KERNELS, BWD_SOURCE, bwd_attributes, bwd_buffers,
        flash_attention_fwd, launch_bwd)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    print(f"[card] {card()}")
    names = ["checked in"] + [os.path.abspath(s) for s in args.source]
    dirs = [CSRC] + [os.path.abspath(s) for s in args.source]
    with ThreadPoolExecutor(len(dirs)) as pool:
        built = dict(zip(names, pool.map(build, enumerate(dirs))))
    for name, (_, log) in built.items():
        for ln in report(log):
            print(f"[build] {name}: {ln}")
    libs = {name: ctypes.CDLL(lib) for name, (lib, _) in built.items()}

    def use(name):  # the wrappers load BWD_SOURCE through build's cache
        kb._LIBS[BWD_SOURCE] = libs[name]

    dev = torch.device("cuda", 0)
    bad = 0
    use("checked in")
    probe = libs["checked in"].flash_attn_bwd_wgmma_probe
    probe.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    g = torch.Generator(dev).manual_seed(0)
    for hd in (16, 64):
        for which in (0, 1):
            x = torch.randn(64, 64 if which else hd, generator=g, device=dev).to(torch.bfloat16)
            y = torch.randn(64, hd, generator=g, device=dev).to(torch.bfloat16)
            d = torch.empty(64, hd if which else 64, device=dev)
            err = probe(x.data_ptr(), y.data_ptr(), d.data_ptr(), hd, which,
                        torch.cuda.current_stream(dev).cuda_stream)
            torch.cuda.synchronize(dev)
            ref = x.float() @ (y.float() if which else y.float().T)
            e = (d - ref).abs().max().item() if not err else float("inf")
            ok = e <= 1e-3
            bad += not ok
            print(f"[probe] hd {hd} {'x y (A in registers, B MN-major)' if which else 'x y^T (K-major)'}: "
                  f"error {err}, max|d - matmul| {e:.3e}{'' if ok else '  FAILED'}")

    for name in names:
        use(name)
        for i, shape in enumerate(CHECKS):
            B, S, H, KH, hd, window, causal = shape
            q, k, v = qkv(shape, torch.bfloat16, dev, seed=400 + i)
            do = torch.randn(q.shape, generator=torch.Generator(dev).manual_seed(500 + i),
                             device=dev).to(torch.bfloat16)
            o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
            runs = []
            for _ in range(2 if name == "checked in" else 1):
                bufs = bwd_buffers(q, k, v, o, lse, do, window=window)
                for kernel in BWD_KERNELS:
                    launch_bwd(kernel, bufs, causal=causal, window=window)
                runs.append(bufs)
            torch.cuda.synchronize(dev)
            ref = attention_bwd_ref(q, k, v, o, lse, do, causal=causal, window=window)
            line = []
            for what, r in zip(("dq", "dk", "dv"), ref):
                got = runs[0][what]
                dd = (got.float() - r.float()).abs()
                excess = (dd - TOL - TOL * r.float().abs()).max().item()
                finite = bool(torch.isfinite(got).all())
                same = all(torch.equal(b[what], got) for b in runs[1:])
                ok = excess <= 0 and finite and same
                bad += not ok
                line.append(f"{what} {dd.max().item():.3e}"
                            + ("" if same else " (bits differ between launches)")
                            + ("" if ok else " FAILED"))
            print(f"[check] {name} {shape}: " + ", ".join(line))
            del q, k, v, do, o, lse, runs, ref

    def time_ms(fn) -> float:
        for _ in range(3):
            fn()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.iters):
            fn()
        stop.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(stop) / args.iters

    for label, shape in TIMED.items():
        B, S, H, KH, hd, window, causal = shape
        q, k, v = qkv(shape, torch.bfloat16, dev, seed=97)
        do = torch.randn(q.shape, generator=torch.Generator(dev).manual_seed(96),
                         device=dev).to(torch.bfloat16)
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window, return_lse=True)
        bufs = bwd_buffers(q, k, v, o, lse, do, window=window)
        launch_bwd("flash_attn_bwd_pre", bufs, causal=causal, window=window)
        times = {(n, kern): [] for n in names for kern in BWD_KERNELS[1:]}
        for order in (names, names[::-1]):
            for name in order:
                use(name)
                for kern in BWD_KERNELS[1:]:
                    times[(name, kern)].append(time_ms(
                        lambda: launch_bwd(kern, bufs, causal=causal, window=window)))
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
        sdpa = time_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), do.transpose(1, 2),
                                                   retain_graph=True))
        bounds = attention_bwd_bounds(shape)
        for name in names:
            use(name)
            for kern in BWD_KERNELS[1:]:
                attrs = bwd_attributes(kern, hd, torch.bfloat16)
                ms = times[(name, kern)]
                print(f"[timing] {label} {shape} {name} {kern}: ms {ms[0]:.4f} / "
                      f"{ms[1]:.4f}; bound {bounds[kern][0]:.4f} ({bounds[kern][1]}); "
                      f"registers {attrs['registers']}, local {attrs['local_bytes']}, "
                      f"shared {attrs['shared_bytes']}")
        print(f"[timing] {label} {shape} SDPA backward alone: {sdpa:.4f} ms; "
              f"whole bound {bounds['whole'][0]:.4f}")
        del q, k, v, do, o, lse, bufs, qt, kt, vt, ot
    use("checked in")
    if bad:
        print(f"flash_bwd_compare: {bad} check(s) failed", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
