#!/usr/bin/env python3
"""Time the port's bf16 SSD kernels (``ssd_bf16.cu``) at mamba2-780m's
serving shape on one NVIDIA GPU, two ways (no JAX needed):

    python3 tools/ssd_tune.py

- head blocks: ``ssd_chunk_state`` and ``ssd_chunk_scan`` at each head block
  in HEAD_BLOCKS (the heads a block walks; the wrappers pass
  ``STATE_HEAD_BLOCK`` and ``SCAN_HEAD_BLOCK``), called through the
  checked-in library's C entries, by CUDA events, in two rounds (ascending,
  then descending);
- parts of the scan: copies of the source under build/ssd_tune/, each with
  one part of ``ssd_chunk_scan`` switched off (PARTS), built together with
  the port's nvcc flags and timed at the default head block in turns with
  the whole kernel.  A copy computes a wrong y; what it measures is the time
  the part costs where it stands.

It exits non-zero if a build fails or an edit no longer finds its place in
the source.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src/repro_torch/kernels/ssd_scan/csrc/ssd_bf16.cu")
OUT = os.path.join(ROOT, "build", "ssd_tune")
HEAD_BLOCKS = {"ssd_chunk_state": (1, 2, 3, 4, 6, 8, 12, 16),
               "ssd_chunk_scan": (3, 4, 6, 8, 12, 16, 24)}
# part -> (text in ssd_chunk_scan, the text that switches it off)
PARTS = {
    "scores . x (the decay, the split and the products)": (
        "  const int t = lane % 4;\n  uint32_t ahi[4], alo[4];\n",
        "  const int t = lane % 4;\n  uint32_t ahi[4], alo[4];\n  return;\n"),
    "the products of scores . x": (
        "    mma_split(acc[2 * pp], ahi, alo, b[0], b[1]);\n"
        "    mma_split(acc[2 * pp + 1], ahi, alo, b[2], b[3]);\n",
        "    acc[2 * pp][0] += __uint_as_float((ahi[0] ^ alo[0] ^ ahi[3] ^ alo[3] ^ b[0]"
        " ^ b[2]) & 0x3f000000u);\n"),
    "the carry C . h_in": (
        "for (int kn = 0; kn < N / 16; ++kn) {\n        uint32_t a[4];\n"
        "        ldmatrix_x4(a, cs + row_pairs<WC>(s0, 2 * kn, lane));",
        "for (int kn = 0; kn < 0; ++kn) {\n        uint32_t a[4];\n"
        "        ldmatrix_x4(a, cs + row_pairs<WC>(s0, 2 * kn, lane));"),
    "the split of h_in": (
        "for (int i = threadIdx.x; i < P * N / 4; i += SCAN_THREADS) {\n"
        "        const int p = i / (N / 4)",
        "for (int i = threadIdx.x; i < 0; i += SCAN_THREADS) {\n"
        "        const int p = i / (N / 4)"),
}


def variants() -> dict:
    text = open(SRC).read()
    out = {"whole kernel": text}
    for part, (old, new) in PARTS.items():
        if text.count(old) != 1:
            raise SystemExit(f"the edit for {part!r} no longer finds its place in {SRC}")
        out[f"without {part}"] = text.replace(old, new)
    both = out["without scores . x (the decay, the split and the products)"]
    out["without scores . x and the carry"] = both.replace(*PARTS["the carry C . h_in"])
    return out


def build(job):
    from repro_torch.kernels import build as kb
    i, text = job
    d = os.path.join(OUT, str(i))
    os.makedirs(d, exist_ok=True)
    src, lib = os.path.join(d, "ssd_bf16.cu"), os.path.join(d, "libssd_bf16.so")
    with open(src, "w") as f:
        f.write(text)
    # the copy includes the checked-in source's header (ssd_common.cuh)
    proc = subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-I", os.path.dirname(SRC),
                           "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on variant {i}:\n{proc.stdout}{proc.stderr}")
    return lib


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("ssd_tune: needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.ssd_scan import kernel as K
    from repro_torch.kernels.ssd_scan.ref import chunk_cumsum
    dev = torch.device("cuda", 0)
    print(f"[card] {cs.card_line()}")
    x, dt, A, B, C, D = cs.ssd_inputs(cs.SSD_SERVE + (True,), torch.bfloat16, dev,
                                      seed=99)
    Bt, S, H, P = x.shape
    G, N = B.shape[2:]
    chunk = cs.SSD_SERVE[6]
    cum = chunk_cumsum(dt, A, chunk)
    chunk_in, _ = K.ssd_chunk_state(x, dt, A, B, chunk=chunk)
    h_ins, _ = K.ssd_state_pass(chunk_in, cum, chunk=chunk)
    y, chunk_in2, cum2 = torch.empty_like(x), torch.empty_like(chunk_in), torch.empty_like(cum)
    stream = torch.cuda.current_stream(dev).cuda_stream
    state = K._function(K.BF16_LIBRARY, "ssd_chunk_state", 6, 8)
    scan = K._function(K.BF16_LIBRARY, "ssd_chunk_scan", 8, 8)
    calls = {
        "ssd_chunk_state": lambda hb: state(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), chunk_in2.data_ptr(),
            cum2.data_ptr(), Bt, S, H, G, P, N, chunk, hb, stream),
        "ssd_chunk_scan": lambda hb: scan(
            x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B.data_ptr(), C.data_ptr(),
            D.data_ptr(), h_ins.data_ptr(), y.data_ptr(), Bt, S, H, G, P, N, chunk, hb,
            stream),
    }
    for name, hbs in HEAD_BLOCKS.items():
        for hb in hbs:
            if calls[name](hb):
                raise SystemExit(f"{name} head_block {hb}: launch failed")
        times = {hb: [] for hb in hbs}
        for order in (hbs, hbs[::-1]):
            for hb in order:
                times[hb].append(cs.time_ms(lambda: calls[name](hb), 20))
        for hb in hbs:
            print(f"[heads] {name} head_block {hb}: "
                  + ", ".join(f"{t:.4f}" for t in times[hb]) + " ms")

    texts = variants()
    with ThreadPoolExecutor(len(texts)) as pool:
        libs = dict(zip(texts, pool.map(build, enumerate(texts.values()))))
    fns = {}
    for label, lib in libs.items():
        fn = ctypes.CDLL(lib).ssd_chunk_scan
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        args = (x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B.data_ptr(), C.data_ptr(),
                D.data_ptr(), h_ins.data_ptr(), y.data_ptr(), Bt, S, H, G, P, N, chunk,
                K.SCAN_HEAD_BLOCK, stream)
        if fn(*args):
            raise SystemExit(f"{label}: launch failed")
        fns[label] = (fn, args)
    whole = fns.pop("whole kernel")
    for label, (fn, args) in fns.items():
        ts = [cs.time_ms(lambda: f(*a), 20) for f, a in (whole, (fn, args), (fn, args), whole)]
        print(f"[parts] ssd_chunk_scan {label}: {ts[1]:.4f}, {ts[2]:.4f} ms "
              f"(whole kernel {ts[0]:.4f}, {ts[3]:.4f} ms)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
