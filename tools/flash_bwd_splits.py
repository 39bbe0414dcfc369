#!/usr/bin/env python3
"""Time the bf16 head_dim-256 dK/dV kernel of the flash backward at each
number of parts of its query walk, on one NVIDIA GPU (no JAX needed).

    python3 tools/flash_bwd_splits.py [--max-splits 10]

At recurrentgemma-2b's attention (S 2048, H 10, KH 1, head_dim 256, window
2048) and batch 1 and 4, ``flash_attn_bwd_dkdv`` runs with 1 ..
``--max-splits`` parts (``bwd_buffers(..., splits=n)``; each time includes
the PyTorch sum of the parts), 20 launches a reading by CUDA events, three
readings in turns over the part counts; the part count ``bwd_splits``
picks is marked.  Each count's result is first held against
``attention_bwd_ref`` (bf16 tolerance 2e-2 abs + rel, as chip_smoke.py);
the run exits non-zero if one disagrees.  The card's name and power limit
head the output.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2048, 10, 1, 256, 2048)  # S, H, KH, head_dim, window
TOL = 2e-2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--max-splits", type=int, default=10)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("flash_bwd_splits: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels.flash_attention.kernel import (
        BWD_KERNELS, bwd_buffers, bwd_splits, flash_attention_fwd, launch_bwd)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}")
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    S, H, KH, hd, window = SHAPE
    bad = 0
    for B in (1, 4):
        g = torch.Generator(dev).manual_seed(B)
        q, do = (torch.randn(B, S, H, hd, generator=g, device=dev).to(torch.bfloat16)
                 for _ in range(2))
        k, v = (torch.randn(B, S, KH, hd, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(2))
        o, lse = flash_attention_fwd(q, k, v, window=window, return_lse=True)
        ref = attention_bwd_ref(q, k, v, o, lse, do, window=window)[1:]
        picked = bwd_splits(B, S, H, KH, hd, torch.bfloat16, sms)
        bufs = {n: bwd_buffers(q, k, v, o, lse, do, window=window, splits=n)
                for n in range(1, args.max_splits + 1)}
        for n, b in bufs.items():
            for name in BWD_KERNELS:
                launch_bwd(name, b, causal=True, window=window)
            torch.cuda.synchronize()
            for got, r in zip((b["dk"], b["dv"]), ref):
                d = (got.float() - r.float()).abs()
                bad += bool((d > TOL + TOL * r.float().abs()).any())
        times = {n: [] for n in bufs}
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        for _ in range(3):
            for n, b in bufs.items():
                for _ in range(3):
                    launch_bwd("flash_attn_bwd_dkdv", b, causal=True, window=window)
                start.record()
                for _ in range(20):
                    launch_bwd("flash_attn_bwd_dkdv", b, causal=True, window=window)
                end.record()
                torch.cuda.synchronize()
                times[n].append(start.elapsed_time(end) / 20)
        for n, ts in times.items():
            print(f"[splits] B={B} splits={n} blocks={B * KH * -(-S // 64) * n}: "
                  f"dkdv ms " + " ".join(f"{t:.4f}" for t in ts)
                  + ("  <- bwd_splits" if n == picked else ""))
        del bufs
        torch.cuda.empty_cache()
    print(f"[splits] {bad} results of {2 * 2 * args.max_splits} disagree with "
          f"attention_bwd_ref (tol {TOL:g} abs + rel)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
