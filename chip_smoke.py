#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any that fails ends the run with a non-zero exit:
  1. the card (``nvidia-smi`` name and power limit) and the build of every
     CUDA kernel from the checkout's sources, with nvcc's register and
     shared-memory report;
  2. every kernel against its plain PyTorch version on the card, over the
     grid of ``tests/test_kernels.py`` plus a ragged length, a non-causal
     case and the serving shape, each in f32 and bf16 (tolerances: f32
     2e-5, bf16 8e-3, abs + rel);
  3. the kernel's time at the serving shape beside its plain version, one
     PyTorch library call computing the same function (a yardstick the port
     never calls) and the least time the card could take;
  4. the main path: ``repro_torch.launch.serve`` serves 8 requests of
     full-width qwen3-0.6b (random weights from a seed), with the launch
     counts read around it; then one prefill of the same weights through the
     kernel and through plain attention, whose logits must agree;
  5. a JSON line per the kernel table, then the last line
     ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s
# Kernel against plain, abs + rel.  f32: tests/test_kernels.py's 2e-5.  bf16:
# both compute in f32 from the same bf16 inputs and round the output to bf16
# once, so they differ by at most one bf16 step of the output, at most
# 2**-7 |o| < 8e-3 |o| (tests/test_kernels.py allows 2e-2).
TOL = {"float32": 2e-5, "bfloat16": 8e-3}
# (B, S, H, KH, hd, window, causal): tests/test_kernels.py's grid, a ragged
# length, a non-causal case; the serving shape is added last, in both types.
GRID = [
    (1, 128, 2, 2, 64, None, True),
    (2, 256, 4, 2, 64, None, True),
    (1, 256, 4, 1, 128, None, True),
    (2, 256, 4, 2, 64, 64, True),
    (1, 512, 2, 2, 64, 128, True),
    (2, 1000, 4, 2, 64, None, True),
    (1, 300, 4, 2, 128, None, False),
]
SERVE_SHAPE = (4, 2048, 16, 8, 64, None, True)  # qwen3-0.6b prefill attention
SERVE_ARGV = ["--arch", "qwen3-0.6b", "--no-reduced", "--requests", "8",
              "--batch", "4", "--prompt-len", "2048", "--max-new", "32"]
# Kernel-vs-plain logits of one full-width prefill: both paths keep f32
# softmax statistics and round each attention output to bf16, so they differ
# where a sum taken in another order rounds to the neighbouring bf16 value
# (a relative step of 2**-8).  Such steps enter the residual stream in each of
# 28 layers; with logits of unit scale (random init) 28 * 2**-8 ~ 0.11 bounds
# their sum when every layer adds one in the same direction.
LOGIT_ATOL = 0.11


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list:
    """One line per compiled kernel: registers, shared memory, spills."""
    lines, entry, spills = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
        elif "spill stores" in ln and entry:
            spills = ln.strip()
        elif "Used" in ln and entry:
            lines.append(f"{entry}: {ln.split(':', 1)[1].strip()}; {spills}")
            entry = None
    return lines


def qkv(shape, dtype, device, seed):
    import torch
    B, S, H, KH, hd = shape[:5]
    g = torch.Generator(device).manual_seed(seed)
    return [torch.randn(s, generator=g, device=device).to(dtype)
            for s in ((B, S, H, hd), (B, S, KH, hd), (B, S, KH, hd))]


def excess_error(got, ref, tol: float) -> tuple:
    """(max |got - ref|, max of |got - ref| - (tol + tol |ref|))."""
    d = (got.float() - ref.float()).abs()
    return d.max().item(), (d - tol - tol * ref.float().abs()).max().item()


def kernel_vs_plain(device) -> float:
    """Phase 2; returns the max abs error at the serving shape in bf16."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import attention_ref
    err = None
    for i, shape in enumerate(GRID + [SERVE_SHAPE]):
        for name in ("float32", "bfloat16"):
            q, k, v = qkv(shape, getattr(torch, name), device, seed=i)
            B, S, H, KH, hd, window, causal = shape
            got = flash_attention_fwd(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize(device)
            ref = attention_ref(q, k, v, causal=causal, window=window)
            err, excess = excess_error(got, ref, TOL[name])
            print(f"[kernel] flash_attn_fwd {name} B={B} S={S} H={H} KH={KH} "
                  f"hd={hd} window={window} causal={causal}: max|err| {err:.3e} "
                  f"(tol {TOL[name]:g} abs + rel)")
            check(got.dtype == q.dtype and got.shape == q.shape
                  and bool(torch.isfinite(got).all()), "bad kernel output")
            check(excess <= 0, f"kernel disagrees with plain at {shape} {name}")
    return err  # the serving shape in bf16, the main path's case


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(shape, dtype_bytes: int, peak_flops: float) -> tuple:
    """Least time for this run's attention: each of q, k, v, o moved once,
    4 * hd flops per (query, key) pair the masks keep."""
    B, S, H, KH, hd, window, causal = shape
    pairs = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        hi = i + 1 if causal else S
        pairs += hi - lo
    flops = 4 * hd * B * H * pairs
    nbytes = dtype_bytes * (2 * B * S * H * hd + 2 * B * S * KH * hd)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def kernel_timing(device) -> dict:
    """Phase 3, at the serving shape (bf16, causal)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import attention_ref
    q, k, v = qkv(SERVE_SHAPE, torch.bfloat16, device, seed=99)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = {
        "ms": time_ms(lambda: flash_attention_fwd(q, k, v, causal=True), 20),
        "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=True), 5),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20),
    }
    out["bound_ms"], out["bound_by"] = attention_bound_ms(SERVE_SHAPE, 2,
                                                          PEAK_BF16_FLOPS)
    print("[timing] flash_attn_fwd at B=4 S=2048 H=16 KH=8 hd=64 bf16 causal: "
          + ", ".join(f"{k} {v}" for k, v in out.items()))
    return out


def serve_and_check(device) -> tuple:
    """Phase 4: the main path, its launch counts, and in-model parity."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import serve
    from repro_torch.models.lm import init_params
    from repro_torch.models.steps import make_prefill_step

    cfg = ARCHS["qwen3-0.6b"]
    torch.cuda.reset_peak_memory_stats(device)
    LAUNCHES.clear()
    stats = serve.main(SERVE_ARGV)
    launches = dict(LAUNCHES)
    stats["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    print("[serve] " + json.dumps(stats))
    print(f"[serve] launches during serving: {launches}")
    check(stats["arch"] == cfg.name, "serve did not run the full-width config")
    check(launches.get("flash_attn_fwd", 0) == cfg.n_layers * stats["rounds"],
          f"expected {cfg.n_layers} kernel launches per prefill round")

    model = init_params(cfg, torch.Generator(device).manual_seed(0))
    B, S = SERVE_SHAPE[:2]
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, size=(B, S))
    batch = {"tokens": torch.from_numpy(prompt).to(device)}
    with torch.inference_mode():
        kern, _ = make_prefill_step(cfg, impl="auto")(model, batch)
        plain, _ = make_prefill_step(cfg, impl="reference")(model, batch)
    check(kern.shape == (B, 1, cfg.vocab) and bool(torch.isfinite(kern).all()),
          "prefill logits are not finite or of the wrong shape")
    diff = (kern - plain).abs().max().item()
    same = torch.equal(kern[:, -1].argmax(-1), plain[:, -1].argmax(-1))
    print(f"[parity] full-width prefill logits, kernel vs plain attention: "
          f"max|diff| {diff:.4e} (tol {LOGIT_ATOL}), |logit| max "
          f"{plain.abs().max().item():.3f}, greedy tokens equal: {same}")
    check(diff <= LOGIT_ATOL, "kernel and plain prefill logits disagree")
    check(same, "kernel and plain prefill pick different greedy tokens")
    return stats, launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    print(f"[card] {card_line()}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t = time.perf_counter()
    logs = build.build_all()
    print(f"[build] {len(logs)} kernel source(s) in {time.perf_counter() - t:.1f}s")
    for name, log in logs.items():
        for ln in ptxas_summary(log):
            print(f"[build] {name}: {ln}")

    err = kernel_vs_plain(device)
    timing = kernel_timing(device)
    stats, launches = serve_and_check(device)

    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attn_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
        "launches": launches.get("flash_attn_fwd", 0), "max_abs_err": err,
        **timing}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))  # the smoke drives cuda:0 alone
    return 0


if __name__ == "__main__":
    sys.exit(main())
