#!/usr/bin/env python3
"""Where a training step's time goes, on one NVIDIA GPU (no JAX needed).

    python3 tools/train_profile.py                       # 2 steps, then 2 profiled
    python3 tools/train_profile.py --warmup 4 --steps 1
    python3 tools/train_profile.py --arch mamba2-780m
    python3 tools/train_profile.py --arch recurrentgemma-2b --batch 2
    python3 tools/train_profile.py --arch granite-moe-3b-a800m
    python3 tools/train_profile.py --arch smollm-135m --batch 2 --seq 32 --warmup 4

Builds the port's kernels, trains a full-width model (qwen3-0.6b by
default; smollm-135m, mamba2-780m, recurrentgemma-2b, granite-moe-3b-a800m
or whisper-medium, fed zero encoder frames) at batch 4 x 2048
unless ``--batch`` or ``--seq`` says otherwise (``chip_smoke.py``'s
training cells; its physical mode's jobs train at 2 x 32; random weights,
synthetic tokens):
``--warmup`` steps of ``repro_torch.launch.train``'s step function
unprofiled, then ``--steps`` more under ``torch.profiler`` (CPU and CUDA
activities), each ending in a ``torch.cuda.synchronize()``.  Prints the
host-clock step times, the device time of every kernel summed by name (the
top rows), the same time grouped into the port's kernels (flash, SSD and
RG-LRU, forward and backward), bf16 and f32 matrix products (cuBLAS and CUTLASS kernels, by the types in their names)
and everything else, the device operations a step, the host operations
that take the most host time, and the device's busy
share of the profiled wall time (the kernels of one stream do not overlap,
so their sum is the busy time).
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def category(name: str) -> str:
    """The group of a kernel, from its name."""
    low = name.lower()
    if "flash_attn_bwd" in low:
        return "flash backward kernels"
    if "flash_attn_fwd" in low:
        return "flash forward kernel"
    if "ssd_bwd" in low:
        return "SSD backward kernels"
    if any(s in low for s in ("ssd_chunk", "ssd_state_pass")):
        return "SSD forward kernels"
    if "rglru_scan_bwd" in low:
        return "RG-LRU backward kernel"
    if "rglru_scan" in low:
        return "RG-LRU scan kernel"
    if any(s in low for s in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        # cuBLAS's f32 kernels name their type (f32f32, sgemm); its bf16 ones
        # may not (nvjet)
        return "matrix products, f32" if any(s in low for s in ("f32f32", "sgemm")) \
            else "matrix products, bf16"
    return "everything else (elementwise, reductions, copies, indexing)"


def device_time_us(evt) -> float:
    """An event's own device time in microseconds, across torch versions."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--arch", default="qwen3-0.6b",
                    choices=("qwen3-0.6b", "smollm-135m", "mamba2-780m",
                             "recurrentgemma-2b", "granite-moe-3b-a800m",
                             "whisper-medium"))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import SyntheticTokens, shard_batch
    from repro_torch.kernels import build
    from repro_torch.models.steps import (enc_embeds, init_train_state,
                                          make_train_step)
    from repro_torch.train.optimizer import OptConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    build.build_all()
    cfg = ARCHS[args.arch]
    state = init_train_state(cfg, torch.Generator(device).manual_seed(0))
    step_fn = make_train_step(cfg, OptConfig(total_steps=1000))
    src = SyntheticTokens(cfg.vocab, args.batch, args.seq, seed=0)

    def step():
        nonlocal state
        t = time.perf_counter()
        batch = shard_batch(src.next_batch(), device)
        if cfg.enc_dec:
            batch["enc_embeds"] = enc_embeds(cfg, args.batch, device)
        state, metrics = step_fn(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize(device)
        return 1e3 * (time.perf_counter() - t)

    warm = [step() for _ in range(args.warmup)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        timed = [step() for _ in range(args.steps)]
        wall_ms = 1e3 * (time.perf_counter() - t0)
    print(f"[profile] {torch.cuda.get_device_name(0)}; {cfg.name} batch "
          f"{args.batch} x {args.seq}; step ms unprofiled {warm}, profiled {timed}; "
          f"peak memory {torch.cuda.max_memory_allocated(device)} bytes")

    kernels, launched = collections.Counter(), 0
    for evt in prof.key_averages():
        if evt.device_type is not None and "cuda" in str(evt.device_type).lower():
            kernels[evt.key] += device_time_us(evt)
            launched += evt.count
    busy_ms = sum(kernels.values()) / 1e3
    print(f"[profile] device time of the kernels {busy_ms:.3f} ms over "
          f"{args.steps} steps; profiled wall time {wall_ms:.3f} ms; busy share "
          f"{busy_ms / wall_ms:.4f}; {launched / args.steps:.0f} device "
          "operations (kernels, copies, sets) a step")
    groups = collections.Counter()
    for name, us in kernels.items():
        groups[category(name)] += us
    for name, us in groups.most_common():
        print(f"[profile] {us / 1e3 / args.steps:10.3f} ms a step  "
              f"{us / 1e3 / busy_ms:7.2%}  {name}")
    print("[profile] top kernels by device time, ms a step:")
    for name, us in kernels.most_common(25):
        print(f"[profile] {us / 1e3 / args.steps:10.3f}  {name[:150]}")
    host = sorted((e for e in prof.key_averages() if e.device_type is not None
                   and "cpu" in str(e.device_type).lower()),
                  key=lambda e: -e.self_cpu_time_total)
    print("[profile] top host operations by their own host time, ms a step "
          "(calls a step):")
    for e in host[:15]:
        print(f"[profile] {e.self_cpu_time_total / 1e3 / args.steps:10.3f} "
              f"({e.count / args.steps:.0f})  {e.key[:100]}")
    return 0 if busy_ms > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
