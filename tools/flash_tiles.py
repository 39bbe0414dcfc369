#!/usr/bin/env python3
"""Build the port's flash-attention kernel with other tensor-core tilings and
time each beside the checked-in one, on one NVIDIA GPU (no JAX needed).

    python3 tools/flash_tiles.py                       # the tilings in TILINGS
    python3 tools/flash_tiles.py "64: BM = 64, BN = 64, MIN_BLOCKS = 3"

A tiling replaces the `TcConfig<hd>` row of
src/repro_torch/kernels/flash_attention/csrc/flash_attn_fwd.cu in a copy under
build/flash_tiles/.  Every copy and the checked-in source are built together
with the port's nvcc flags; ptxas's registers and spills are printed for each
bf16 instantiation at the tiling's head_dim.  Each build is held against the
plain version at the serving shape of its head_dim (chip_smoke.py's shapes
and bf16 tolerance), then timed there by CUDA events in turns with the
checked-in build (checked-in, tiling, tiling, checked-in), three rounds each.
It exits non-zero if a build fails or a tiling disagrees with the plain
version.
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src/repro_torch/kernels/flash_attention/csrc/flash_attn_fwd.cu")
OUT = os.path.join(ROOT, "build", "flash_tiles")
# Tilings tried beside the checked-in rows (128 query rows and 8 warps a
# block, 64 keys a tile at hd 64 and 256); the first hd-256 row is the
# 4-warp, 32-key starting point the design was measured against.
TILINGS = [
    "64: BM = 128, BN = 64, MIN_BLOCKS = 1",
    "64: BM = 128, BN = 32, MIN_BLOCKS = 2",
    "64: BM = 64, BN = 64, MIN_BLOCKS = 3",
    "256: BM = 64, BN = 32, MIN_BLOCKS = 2",
    "256: BM = 64, BN = 64, MIN_BLOCKS = 1",
    "256: BM = 128, BN = 32, MIN_BLOCKS = 1",
]


def source(tiling: str) -> str:
    hd, row = tiling.split(":", 1)
    text, n = re.subn(r"(struct TcConfig<%d> \{ static constexpr int )[^;]*;" % int(hd),
                      lambda m: m.group(1) + row.strip() + ";", open(SRC).read())
    if n != 1:
        raise SystemExit(f"no TcConfig<{hd}> row in {SRC}")
    return text


def build(job):
    from repro_torch.kernels import build as kb
    name, text = job
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    src = os.path.join(d, "flash_attn_fwd.cu")
    with open(src, "w") as f:
        f.write(text)
    lib = os.path.join(d, "lib.so")
    proc = subprocess.run([kb._nvcc(), *kb.NVCC_FLAGS, "-o", lib, src],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return name, lib, proc.returncode, proc.stdout


def launcher(lib_path: str):
    import torch
    fn = ctypes.CDLL(lib_path).flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(q, k, v, causal, window):
        B, S, H, hd = q.shape
        o = torch.empty_like(q)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, H,
                 k.shape[2], hd, 1, 1.0 / hd ** 0.5, int(causal), window or 0,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed with CUDA error {err}")
        return o
    return call


def main(argv) -> int:
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention.ref import attention_ref
    if not torch.cuda.is_available():
        print("flash_tiles: needs a CUDA device", file=sys.stderr)
        return 1
    tilings = argv or TILINGS
    jobs = [("checked_in", open(SRC).read())] + [
        (f"t{i}", source(t)) for i, t in enumerate(tilings)]
    print(f"[card] {cs.card_line()}")
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = {name: (lib, rc, log) for name, lib, rc, log in pool.map(build, jobs)}
    labels = {"checked_in": "checked-in", **{f"t{i}": t for i, t in enumerate(tilings)}}
    for name, (lib, rc, log) in built.items():
        if rc:
            print(f"[build] {labels[name]}: nvcc failed\n{log}")
            return 1
        for ln in cs.ptxas_summary(log):
            hd = re.search(r"flash_attn_fwd_tc_kernelILi(\d+)E", ln)
            if hd and (name == "checked_in" or labels[name].startswith(hd.group(1) + ":")):
                print(f"[build] {labels[name]} hd {hd.group(1)}: {ln.split(': ', 1)[1]}")
    device = torch.device("cuda", 0)
    base = launcher(built["checked_in"][0])
    ok = True
    for name in [n for n in built if n != "checked_in"]:
        hd = int(labels[name].split(":")[0])
        shape = cs.SERVE_SHAPE if hd == cs.SERVE_SHAPE[4] else cs.RG_SERVE_SHAPE
        window = shape[5]
        q, k, v = cs.qkv(shape, torch.bfloat16, device, seed=99)
        call = launcher(built[name][0])
        err, excess = cs.excess_error(call(q, k, v, True, window),
                                      attention_ref(q, k, v, causal=True, window=window),
                                      cs.TOL["bfloat16"])
        ok &= excess <= 0
        times = {"checked-in": [], "tiling": []}
        for _ in range(3):
            for who, fn in (("checked-in", base), ("tiling", call), ("tiling", call),
                            ("checked-in", base)):
                times[who].append(cs.time_ms(lambda: fn(q, k, v, True, window), 20))
        print(f"[tiles] hd {hd} {labels[name]}: max|err| {err:.3e} "
              f"({'ok' if excess <= 0 else 'DISAGREES'}), ms {min(times['tiling'])} "
              f"to {max(times['tiling'])}; checked-in ms {min(times['checked-in'])} "
              f"to {max(times['checked-in'])}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
