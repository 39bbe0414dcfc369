#!/usr/bin/env python3
"""Check and time the RG-LRU scan and its backward (``csrc/rglru_scan.cu``)
beside another copy of the source, on one NVIDIA GPU (no JAX needed):

    git show <commit>:src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu \\
        > build/rglru_parent/rglru_scan.cu
    python3 tools/rglru_compare.py [--source build/rglru_parent/rglru_scan.cu]
        [--chunks 32,64,128,256] [--iters 50]

Builds the checked-in source and each ``--source`` under
``build/rglru_compare/`` with the port's nvcc flags, all at once, and prints
ptxas's registers and spills of every kernel in them.  A source whose
entries take no chunk (the one-thread-a-chain kernels before the chunked
scan) is called with its own arguments.  Then:
- every build's scan and backward against ``rglru_scan_ref`` and
  ``rglru_scan_bwd_ref`` (``chip_smoke.RGLRU_TOL`` in f32, one bf16 step on
  bf16 h_seq, da and du), and a chunked build's against the chunked mirrors
  with the same chunk, to the bit;
- both kernels of every build at recurrentgemma-2b's training shape (B 1)
  and its serving shape (B 4), f32, in turns (the builds in order, then
  reversed), by CUDA events over ``--iters`` launches queued behind a
  ``torch.cuda._sleep`` (``chip_smoke.time_ms(hold=True)``) so that the
  host's launch cost is not timed, each beside its bound; the checked-in
  build at its default chunk (``kernel.chunk_length``) and also through the
  wrapper (``rglru_scan_fwd`` / ``rglru_scan_bwd``, not held: the wrapper's
  host cost included, as ``chip_smoke.py``'s ms);
- with ``--chunks``, every chunked build at each chunk length at B 1 to 4
  (where the chunk rule's constants come from), and at batch 1 with half
  the sequence or half the channels (a and u 21 MB, well inside L2).
It exits non-zero if a build fails or a check disagrees.  The card's name
and power limit head the output.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu")
OUT = os.path.join(ROOT, "build", "rglru_compare")
V, I = ctypes.c_void_p, ctypes.c_int
# (B, S, R, h0, model a): recurrentgemma-2b's training batch and its serving
# batch, then a batch between them
TIMED = {"training B 1": (1, 2048, 2560, False, True),
         "serving B 4": (4, 2048, 2560, False, True)}
SWEEP = [(B, 2048, 2560, False, True) for B in (1, 2, 3, 4)] + [
    (1, 1024, 2560, False, True), (1, 2048, 1280, False, True)]  # half the bytes
CHECKS = [(1, 2048, 2560, False, True), (4, 2048, 2560, True, True),
          (2, 300, 100, True, False), (1, 4100, 640, True, True)]


def build(job):
    from repro_torch.kernels import build as kb
    i, src = job
    d = os.path.join(OUT, str(i))
    os.makedirs(d, exist_ok=True)
    lib = os.path.join(d, "librglru_scan.so")
    proc = subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr


class Build:
    """One build's two entries, called with or without a chunk."""

    def __init__(self, path: str, source: str):
        self.lib = ctypes.CDLL(path)
        self.chunked = "int chunk" in open(source).read()
        n = 1 if self.chunked else 0
        self.lib.rglru_scan.argtypes = [V] * (6 + n) + [I] * (4 + n) + [V]
        self.lib.rglru_scan_bwd.argtypes = [V] * (8 + n) + [I] * (4 + n) + [V]

    def fwd(self, a, u, h0, hs, hf, hst, ws, chunk, stream):
        B, S, R = a.shape
        dt = int(a.element_size() == 2)  # 0 float32, 1 bfloat16
        p = [_ptr(t) for t in (a, u, h0, hs, hf, hst)]
        if self.chunked:
            return self.lib.rglru_scan(*p, _ptr(ws), B, S, R, chunk, dt, stream)
        return self.lib.rglru_scan(*p, B, S, R, dt, stream)

    def bwd(self, a, hst, h0, dh, dhf, ws, da, du, dh0, chunk, stream):
        B, S, R = a.shape
        dt = int(a.element_size() == 2)
        if self.chunked:
            return self.lib.rglru_scan_bwd(*[_ptr(t) for t in (a, hst, h0, dh, dhf, ws,
                                                                da, du, dh0)],
                                           B, S, R, chunk, dt, stream)
        return self.lib.rglru_scan_bwd(*[_ptr(t) for t in (a, hst, h0, dh, dhf, da,
                                                            du, dh0)],
                                       B, S, R, dt, stream)


def _ptr(t):
    return None if t is None else t.data_ptr()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", action="append", default=[],
                    help="another rglru_scan.cu, say an earlier commit's")
    ap.add_argument("--chunks", default="",
                    help="comma-separated chunk lengths to time the checked-in "
                         "build at")
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("rglru_compare: needs a CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import (PEAK_F32_FLOPS, RGLRU_TOL, TOL, bound, card_line,
                            excess_error, ptxas_summary, rglru_inputs, time_ms)
    from repro_torch.kernels.rglru_scan import kernel as rk
    from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_chunked_ref,
                                                    rglru_scan_bwd_ref,
                                                    rglru_scan_chunked_ref,
                                                    rglru_scan_ref)
    print(f"[card] {card_line()}")
    names = ["checked in"] + [os.path.abspath(s) for s in args.source]
    srcs = [CSRC] + [os.path.abspath(s) for s in args.source]
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = list(pool.map(build, enumerate(srcs)))
    for name, (_, log) in zip(names, built):
        for ln in ptxas_summary(log):
            print(f"[build] {name}: {ln}")
    builds = {name: Build(lib, src) for name, (lib, _), src in zip(names, built, srcs)}
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def buffers(a, u, h0, chunk, dh_seed=None):
        B, S, R = a.shape
        C = rk.n_chunks(S, chunk)
        f32 = dict(dtype=torch.float32, device=dev)
        buf = {"hs": torch.empty_like(u), "hf": torch.empty(B, R, **f32),
               "hst": torch.empty(B, S, R, **f32),
               "ws": torch.empty(2, B, C, R, **f32) if C > 1 else None,
               "da": torch.empty_like(a), "du": torch.empty_like(a),
               "dh0": torch.empty(B, R, **f32)}
        g = torch.Generator(dev).manual_seed(dh_seed or 0)
        buf["dh"] = torch.randn(B, S, R, generator=g, device=dev).to(a.dtype)
        buf["dhf"] = torch.randn(B, R, generator=g, device=dev)
        return buf

    bad = 0
    for name, b in builds.items():
        for i, shape in enumerate(CHECKS):
            for dtype in (torch.float32, torch.bfloat16):
                a, u, h0 = rglru_inputs(shape, dtype, dev, seed=300 + i)
                B, S, R = a.shape
                chunk = rk.chunk_length(B, S, R) if b.chunked else S
                x = buffers(a, u, h0, chunk, dh_seed=400 + i)
                err = b.fwd(a, u, h0, x["hs"], x["hf"], x["hst"], x["ws"], chunk, stream)
                err = err or b.bwd(a, x["hst"], h0, x["dh"], x["dhf"], x["ws"], x["da"],
                                   x["du"], x["dh0"], chunk, stream)
                torch.cuda.synchronize(dev)
                first = torch.zeros_like(x["hst"][:, :1]) if h0 is None else h0[:, None]
                h_prev = torch.cat([first, x["hst"][:, :-1]], 1)
                got = (x["hs"], x["hf"], x["da"], x["du"], x["dh0"])
                oracle = (*rglru_scan_ref(a, u, h0),
                          *rglru_scan_bwd_ref(a, h_prev, x["dh"], x["dhf"]))
                mirror = (*rglru_scan_chunked_ref(a, u, h0, chunk),
                          *rglru_scan_bwd_chunked_ref(a, h_prev, x["dh"], x["dhf"],
                                                      chunk))
                line, ok = [], not err
                for what, o, r, m in zip(("h_seq", "h_final", "da", "du", "dh0"),
                                         got, oracle, mirror):
                    tol = TOL["bfloat16"] if dtype == torch.bfloat16 and \
                        what in ("h_seq", "da", "du") else RGLRU_TOL
                    e, excess = excess_error(o, r, tol)
                    same = torch.equal(o, m)
                    ok &= excess <= 0 and bool(torch.isfinite(o).all()) and same
                    line.append(f"{what} {e:.3e}" + ("" if same else " (not the mirror)"))
                bad += not ok
                print(f"[check] {name} {shape} {str(dtype)[6:]} chunk {chunk} "
                      f"({rk.n_chunks(S, chunk)} chunks), error {err}; max|err| against "
                      f"the oracle: " + ", ".join(line) + ("" if ok else "  FAILED"))
                del a, u, h0, x, got, oracle, mirror, h_prev

    def kernels_ms(b, shape, chunk):
        a, u, h0 = rglru_inputs(shape, torch.float32, dev, seed=98)
        x = buffers(a, u, h0, chunk, dh_seed=96)
        b.fwd(a, u, h0, x["hs"], x["hf"], None, x["ws"], chunk, stream)
        return (time_ms(lambda: b.fwd(a, u, h0, x["hs"], x["hf"], None, x["ws"],
                                      chunk, stream), args.iters, hold=True),
                time_ms(lambda: b.bwd(a, x["hs"], h0, x["dh"], x["dhf"], x["ws"],
                                      x["da"], x["du"], x["dh0"], chunk, stream),
                        args.iters, hold=True))

    for label, shape in TIMED.items():
        B, S, R = shape[:3]
        chunk = rk.chunk_length(B, S, R)
        times = {name: [] for name in names}
        for order in (names, names[::-1]):
            for name in order:
                b = builds[name]
                times[name].append(kernels_ms(b, shape, chunk if b.chunked else S))
        fwd_bound = bound(4 * (3 * B * S * R + B * R), 2 * B * S * R, PEAK_F32_FLOPS)
        bwd_bound = bound(4 * (5 * B * S * R + 2 * B * R), 3 * B * S * R, PEAK_F32_FLOPS)
        for name in names:
            (f0, b0), (f1, b1) = times[name]
            c = rk.n_chunks(S, chunk) if builds[name].chunked else 1
            print(f"[timing] {label} {shape[:3]} f32 {name} ({c} chunks): rglru_scan "
                  f"ms {f0:.4f} / {f1:.4f}, bound {fwd_bound[0]:.5f} ({fwd_bound[1]}); "
                  f"rglru_scan_bwd ms {b0:.4f} / {b1:.4f}, bound {bwd_bound[0]:.5f} "
                  f"({bwd_bound[1]})")
        a, u, h0 = rglru_inputs(shape, torch.float32, dev, seed=98)
        x = buffers(a, u, h0, chunk, dh_seed=96)
        _, _, h_state = rk.rglru_scan_fwd(a, u, h0, return_state=True)
        wf = time_ms(lambda: rk.rglru_scan_fwd(a, u, h0, return_state=True),
                     args.iters)
        wb = time_ms(lambda: rk.rglru_scan_bwd(a, h_state, h0, x["dh"], x["dhf"]),
                     args.iters)
        print(f"[timing] {label} through the wrappers (host cost included): "
              f"rglru_scan_fwd(return_state=True) {wf:.4f} ms, rglru_scan_bwd "
              f"{wb:.4f} ms")
        del a, u, h0, x, h_state

    for chunk in [int(c) for c in args.chunks.split(",") if c]:
        for shape, name in [(s, n) for s in SWEEP for n in names if builds[n].chunked]:
            B, S, R = shape[:3]
            f, b = kernels_ms(builds[name], shape, chunk)
            print(f"[sweep] {name} {shape[:3]} f32 chunk {chunk} ({rk.n_chunks(S, chunk)} "
                  f"chunks, {B * rk.n_chunks(S, chunk) * R} threads): rglru_scan "
                  f"{f:.4f} ms, rglru_scan_bwd {b:.4f} ms")
    if bad:
        print(f"rglru_compare: {bad} check(s) failed", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
