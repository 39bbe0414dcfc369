#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any that fails ends the run with a non-zero exit:
  1. the card (``nvidia-smi`` name and power limit) and the build of every
     CUDA kernel from the checkout's sources (one nvcc per source, all
     started together), with nvcc's register, shared-memory and spill report;
     the run fails if a bf16 (tensor-core) flash instantiation spills;
  2. every kernel against its plain PyTorch version on the card:
     - flash_attn_fwd over the grid of ``tests/test_kernels.py`` plus a
       ragged length, a non-causal case, head_dim 256 (small, ragged and
       windowed, and with a window that bites), cases that straddle the
       tensor-core kernel's tiles, and both serving shapes (qwen3-0.6b's and
       recurrentgemma-2b's), each in f32 (the CUDA-core kernel) and bf16
       (the tensor-core kernel); tolerances f32 2e-5, bf16 8e-3, abs + rel;
     - ssd_chunk against ``ssd_chunk_ref`` over the grid of
       ``tests/test_kernels.py`` and mamba2-780m's serving shape (with that
       test's A and with the model's A), x, B and C in f32 and in bf16, both
       outputs (f32 on both sides: 2e-4 abs + rel); and the padded grid case
       through the whole ``ops.ssd`` against ``ssd_chunked_ref``;
     - rglru_scan against ``rglru_scan_ref`` over the grid of
       ``tests/test_kernels.py``, a ragged length, h0 None and
       recurrentgemma-2b's serving shape with the model's kind of decay, a
       and u in f32 and in bf16, both outputs (f32 1e-5, bf16 h_seq 8e-3);
  3. each kernel's time at its serving shape beside its plain version, one
     PyTorch library call computing the same function where there is one (a
     yardstick the port never calls) and the least time the card could take;
     for flash_attn_fwd also the registers, local and shared bytes of the
     bf16 kernel;
  4. the main paths, each with the launch counts set to 0 just before it and
     read just after: ``repro_torch.launch.serve`` serves 8 requests of
     full-width qwen3-0.6b, then of full-width mamba2-780m, then of
     full-width recurrentgemma-2b (random weights from a seed), each with
     its expected launches per kernel per prefill round and none of any other
     kernel; after each, kernel against plain in the model: for qwen3-0.6b
     the logits of one prefill of the same weights; for mamba2-780m every
     layer's SSD output, and for recurrentgemma-2b every layer's RG-LRU scan
     and attention output, on the plain path's bf16 activations, then the
     logits of one prefill in f32 compute (their bf16 logits are printed
     beside the plain path's own spread, not gated);
  5. a JSON line per the kernel table, then the last line
     ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12    # H100 SXM f32 rate outside the tensor cores
PEAK_BYTES = 3.35e12      # H100 SXM HBM3 bytes/s
# Kernel against plain, abs + rel.  f32: tests/test_kernels.py's 2e-5 (the
# f32 kernel runs on the CUDA cores and rounds nothing but its f32 sums).
# bf16: the plain version computes in f32 from the same bf16 inputs and
# rounds the output to bf16 once: one bf16 step of the output, at most
# 2**-7 |o|.  The tensor-core kernel also rounds P to bf16 as the A operand
# of P.V, as every tensor-core flash kernel does: a relative 2**-8 on each
# weight, which moves o by at most 2**-8 sum_j p_j |v_j| / l, in errors of
# random sign that mostly cancel over a row's keys.  8e-3 abs + rel covers
# both at inputs of unit scale (tests/test_kernels.py allows 2e-2).
TOL = {"float32": 2e-5, "bfloat16": 8e-3}
# (B, S, H, KH, hd, window, causal): tests/test_kernels.py's grid, a ragged
# length, a non-causal case; then cases that straddle the tensor-core
# kernel's tiles (bf16: 128 query rows and 64 keys a tile at hd 64 and 256,
# 64 and 64 at hd 16 and 128): S = 1, 15, 63, 65, 127, 129 and
# 2049, window 1, windows whose first key falls inside a key tile (40, 300),
# KH = H and KH = 1; the serving shape is added last, in both types.
GRID = [
    (1, 128, 2, 2, 64, None, True),
    (2, 256, 4, 2, 64, None, True),
    (1, 256, 4, 1, 128, None, True),
    (2, 256, 4, 2, 64, 64, True),
    (1, 512, 2, 2, 64, 128, True),
    (2, 1000, 4, 2, 64, None, True),
    (1, 300, 4, 2, 128, None, False),
    (1, 1, 2, 1, 64, None, True),
    (2, 15, 4, 4, 64, None, True),
    (1, 63, 4, 1, 64, None, True),
    (1, 65, 2, 2, 64, None, False),
    (1, 127, 4, 2, 64, 1, True),
    (2, 129, 4, 2, 64, 40, True),
    (1, 2049, 4, 2, 64, None, True),
    (1, 2049, 2, 1, 64, 300, True),
    (2, 129, 4, 4, 16, None, True),
    (1, 65, 2, 1, 16, 1, True),
    (1, 129, 4, 2, 128, 40, True),
    (1, 63, 2, 2, 128, None, False),
]
GRID_HD256 = [  # recurrentgemma-2b's head_dim: small, ragged + windowed, biting window
    (1, 128, 4, 1, 256, None, True),
    (1, 300, 10, 1, 256, 128, True),
    (1, 4096, 10, 1, 256, 2048, True),
    (1, 1, 2, 1, 256, None, True),
    (1, 15, 2, 2, 256, None, True),
    (1, 63, 10, 1, 256, None, True),
    (1, 65, 4, 1, 256, 1, True),
    (1, 127, 4, 2, 256, 40, True),
    (1, 129, 2, 1, 256, None, False),
    (1, 2049, 10, 1, 256, 2048, True),
]
SERVE_SHAPE = (4, 2048, 16, 8, 64, None, True)  # qwen3-0.6b prefill attention
RG_SERVE_SHAPE = (4, 2048, 10, 1, 256, 2048, True)  # recurrentgemma-2b's
BATCH, PROMPT = 4, 2048  # the traffic of every served model
# Each path's kernel launches per prefill round: one per layer of the kind
# that runs it (recurrentgemma-2b: 8 attention and 18 RG-LRU layers of 26);
# none of any other kernel.
PATHS = {
    "qwen3-0.6b": {"flash_attn_fwd": 28},
    "mamba2-780m": {"ssd_chunk": 48},
    "recurrentgemma-2b": {"flash_attn_fwd": 8, "rglru_scan": 18},
}


def serve_argv(arch: str) -> list:
    return ["--arch", arch, "--no-reduced", "--requests", "8", "--batch",
            str(BATCH), "--prompt-len", str(PROMPT), "--max-new", "32"]


# Kernel-vs-plain logits of one full-width qwen3-0.6b prefill: both paths
# keep f32 softmax statistics and round each attention output to bf16, so they
# differ where a sum taken in another order, or the kernel's bf16 P, moves the
# f32 output across a rounding boundary to the neighbouring bf16 value (a
# relative step of 2**-8).  Such steps enter the residual stream in
# each of 28 layers; with logits of unit scale (random init) 28 * 2**-8 ~ 0.11
# bounds their sum when every layer adds one in the same direction.
LOGIT_ATOL = 0.11
# mamba2-780m.  In bf16 its 48 random layers amplify a one-step rounding
# difference far beyond n_layers * 2**-8, so its bf16 logits cannot tell a
# faulty kernel from a right one (the script prints them beside the plain
# path's own spread under one f32 ulp of noise in its SSD term, and does not
# gate on them).  Instead:
# - each layer's SSD output, kernel against plain from the same bf16 inputs
#   on the plain path's activations: both compute in f32 and round y to bf16
#   once, so one bf16 step (8e-3 abs + rel, as TOL); the f32 final state
#   2e-4 (SSD_TOL);
# - the logits of one prefill of the same weights in f32 compute, where the
#   paths differ only in the order of f32 sums inside the SSD intra term
#   (relative ~1e-7, phase 2): 2e-3, four times the plain path's own spread
#   under one f32 ulp of noise in that term (printed in every run), and equal
#   greedy tokens.
# recurrentgemma-2b is checked the same way: every layer's RG-LRU scan
# (h_seq after its cast to bf16: one bf16 step, 8e-3 abs + rel; h_final:
# RGLRU_TOL) and attention output (one bf16 step), kernel against plain on
# the plain path's bf16 activations; the logits of one prefill in f32
# compute, where the paths differ only in the order of f32 sums (the scan's
# sequential order against the plain path's log-depth one, the attention
# kernel's against the plain blocked softmax), within the same 2e-3 with
# equal greedy tokens; its bf16 logits printed beside the plain path's own
# spread under one f32 ulp of noise in its scan output.
F32_LOGIT_ATOL = 2e-3
# ssd_chunk against ssd_chunk_ref: both compute in f32 from the same inputs
# and write f32, so the f32 bound of tests/test_kernels.py, abs + rel.
SSD_TOL = 2e-4
# (Bt, S, H, P, G, N, chunk, model A): tests/test_kernels.py's grid (its
# padded case, S 80, goes through ops.ssd), then mamba2-780m's serving shape
# with that test's A and with the model's A = -linspace(1, 16, H), whose
# cum falls to about -2,000 within a chunk.
SSD_GRID = [
    (1, 64, 2, 16, 1, 32, 16, False),
    (2, 128, 4, 16, 2, 32, 32, False),
    (1, 96, 2, 32, 1, 16, 32, False),
]
SSD_SERVE = (4, 2048, 48, 64, 1, 128, 256)  # mamba2-780m prefill SSD
SSD_PADDED = (1, 80, 2, 16, 1, 16, 32, False)
# rglru_scan against rglru_scan_ref: the kernel takes the oracle's f32
# product and sum in the same order with the same rounding (no FMA), so the
# f32 outputs should agree exactly; 1e-5 abs + rel.  h_seq from bf16 inputs
# is rounded to bf16 once on both sides: one bf16 step, TOL["bfloat16"].
RGLRU_TOL = 1e-5
# (B, S, R, h0, model a): tests/test_kernels.py's grid, a ragged S and R,
# h0 None, then recurrentgemma-2b's serving shape with the model's decay
# a = exp(-8 softplus(1) sigmoid(z)), about 3e-5 to 1.
RGLRU_GRID = [
    (1, 64, 64, True, False),
    (2, 128, 128, True, False),
    (2, 96, 192, True, False),
    (2, 300, 100, True, False),
    (1, 37, 5, False, False),
]
RGLRU_SERVE = (4, 2048, 2560, False, True)  # recurrentgemma-2b prefill scan


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
            entry, spills = ln.split("'")[1], ""
        elif "spill stores" in ln and entry:
            spills = ln.strip()
        elif "Used" in ln and entry:
            lines.append(f"{entry}: {ln.split(':', 1)[1].strip()}; {spills}")
            entry = None
    return lines


def spill_gate(summary: list) -> None:
    """Fails the run unless every bf16 (tensor-core) flash instantiation, one
    per head_dim the wrapper takes, reports 0 bytes of spill stores and
    loads in ptxas's report."""
    import re
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    tc = [ln for ln in summary if "flash_attn_fwd_tc_kernel" in ln]
    check(len(tc) == len(HEAD_DIMS),
          f"expected {len(HEAD_DIMS)} tensor-core flash instantiations in "
          f"ptxas's report, found {len(tc)}")
    for ln in tc:
        found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        check(found is not None and found.groups() == ("0", "0"),
              f"a bf16 flash instantiation spills or was not reported: {ln}")


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


def kernel_vs_plain(device) -> dict:
    """Phase 2; returns the max abs error at each serving shape in bf16."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import attention_ref
    errs = {}
    for i, shape in enumerate(GRID + GRID_HD256 + [SERVE_SHAPE, RG_SERVE_SHAPE]):
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
            errs[shape] = err  # bf16 last: the main paths' case
    return {shape: errs[shape] for shape in (SERVE_SHAPE, RG_SERVE_SHAPE)}


def ssd_inputs(shape, dtype, device, seed):
    """x, dt, A, B, C, D drawn as tests/test_kernels.py draws them; x, B
    and C in ``dtype``, the rest f32."""
    import torch
    Bt, S, H, P, G, N, chunk, model_a = shape
    g = torch.Generator(device).manual_seed(seed)

    def draw(*size, lo=None, hi=None):
        if lo is None:
            return torch.randn(size, generator=g, device=device)
        return lo + (hi - lo) * torch.rand(size, generator=g, device=device)

    A = -torch.linspace(1.0, 16.0, H, device=device) if model_a \
        else -draw(H, lo=0.5, hi=2.0)
    return (draw(Bt, S, H, P).to(dtype), draw(Bt, S, H, lo=0.1, hi=0.9), A,
            draw(Bt, S, G, N).to(dtype), draw(Bt, S, G, N).to(dtype), draw(H))


def ssd_kernel_vs_plain(device) -> float:
    """Phase 2 for ssd_chunk; returns the max abs error at the serving shape
    with the model's A in bf16, the main path's case."""
    import torch
    from repro_torch.kernels.ssd_scan.kernel import ssd_chunk
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.kernels.ssd_scan.ref import chunk_cumsum, ssd_chunk_ref
    err = None
    cases = SSD_GRID + [SSD_SERVE + (False,), SSD_SERVE + (True,)]
    for i, shape in enumerate(cases):
        for name in ("float32", "bfloat16"):
            x, dt, A, B, C, _ = ssd_inputs(shape, getattr(torch, name), device,
                                           seed=100 + i)
            chunk = shape[6]
            cum = chunk_cumsum(dt, A, chunk)
            got = ssd_chunk(x, dt, cum, B, C, chunk=chunk)
            torch.cuda.synchronize(device)
            ref = ssd_chunk_ref(x, dt, cum, B, C, chunk=chunk)
            errs = []
            for what, o, r in zip(("y_intra", "chunk_in"), got, ref):
                check(o.dtype == torch.float32 and o.shape == r.shape
                      and bool(torch.isfinite(o).all()), f"bad {what}")
                e, excess = excess_error(o, r, SSD_TOL)
                check(excess <= 0, f"ssd_chunk {what} disagrees with plain "
                      f"at {shape} {name}")
                errs.append(e)
            err = max(errs)
            print(f"[kernel] ssd_chunk {name} (Bt,S,H,P,G,N,chunk,model A)="
                  f"{shape}: min cum {cum.min().item():.1f}, max|err| y_intra "
                  f"{errs[0]:.3e}, chunk_in {errs[1]:.3e} (tol {SSD_TOL:g} "
                  "abs + rel)")
    # the padded case through the whole of ops.ssd: y is rounded to x's
    # dtype on both sides (one step of it in bf16: 8e-3), h_final is f32
    for name in ("float32", "bfloat16"):
        x, dt, A, B, C, D = ssd_inputs(SSD_PADDED, getattr(torch, name), device,
                                       seed=80)
        y, h = ssd(x, dt, A, B, C, D, chunk=SSD_PADDED[6])
        torch.cuda.synchronize(device)
        y_ref, h_ref = ssd(x, dt, A, B, C, D, chunk=SSD_PADDED[6],
                           impl="reference")
        ey, excess_y = excess_error(y, y_ref, TOL[name] if name == "bfloat16"
                                    else SSD_TOL)
        eh, excess_h = excess_error(h, h_ref, SSD_TOL)
        print(f"[kernel] ops.ssd {name} padded {SSD_PADDED}: max|err| y "
              f"{ey:.3e}, h_final {eh:.3e}")
        check(y.shape == x.shape and bool(torch.isfinite(y).all()),
              "bad ops.ssd output")
        check(excess_y <= 0 and excess_h <= 0,
              f"ops.ssd disagrees with ssd_chunked_ref padded {name}")
    return err


def ssd_bound_ms(shape, in_bytes: int, peak_flops: float) -> tuple:
    """Least time for the SSD intra-chunk term: x, dt, cum, B and C read
    once (B and C by group), y_intra and chunk_in (f32) written once;
    2N + 2P flops per causal (q, k) pair and 2·Q·P·N for chunk_in, per
    (batch, head, chunk)."""
    Bt, S, H, P, G, N, Q = shape
    nc = S // Q
    nbytes = (in_bytes * Bt * S * H * P + 4 * 2 * Bt * S * H
              + in_bytes * 2 * Bt * S * G * N
              + 4 * Bt * S * H * P + 4 * Bt * nc * H * P * N)
    flops = Bt * H * nc * (Q * (Q + 1) // 2 * (2 * N + 2 * P) + 2 * Q * P * N)
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def ssd_timing(device) -> dict:
    """Phase 3 for ssd_chunk, at the serving shape (bf16 x, B, C; model A).
    No single PyTorch call computes this function: library_ms is null."""
    import torch
    from repro_torch.kernels.ssd_scan.kernel import ssd_chunk
    from repro_torch.kernels.ssd_scan.ref import chunk_cumsum, ssd_chunk_ref
    x, dt, A, B, C, _ = ssd_inputs(SSD_SERVE + (True,), torch.bfloat16, device,
                                   seed=99)
    chunk = SSD_SERVE[6]
    cum = chunk_cumsum(dt, A, chunk)
    out = {
        "ms": time_ms(lambda: ssd_chunk(x, dt, cum, B, C, chunk=chunk), 20),
        "plain_ms": time_ms(lambda: ssd_chunk_ref(x, dt, cum, B, C, chunk=chunk),
                            3, warmup=1),
        "library_ms": None,
    }
    out["bound_ms"], out["bound_by"] = ssd_bound_ms(SSD_SERVE, 2, PEAK_BF16_FLOPS)
    print("[timing] ssd_chunk at Bt=4 S=2048 H=48 P=64 G=1 N=128 chunk=256 "
          "bf16 (no single PyTorch call computes it: library_ms null): "
          + ", ".join(f"{k} {v}" for k, v in out.items()))
    return out


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


def kernel_timing(device, shape) -> dict:
    """Phase 3 for flash_attn_fwd at a serving shape (bf16, causal; the
    window, where there is one, does not bite at S = 2048, so SDPA's causal
    mask computes the same function)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (attributes,
                                                            flash_attention_fwd)
    from repro_torch.kernels.flash_attention.ref import attention_ref
    B, S, H, KH, hd, window, causal = shape
    check(causal and (window is None or window >= S), "SDPA's mask differs")
    attrs = attributes(hd, torch.bfloat16)
    q, k, v = qkv(shape, torch.bfloat16, device, seed=99)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    out = {
        "ms": time_ms(lambda: flash_attention_fwd(q, k, v, causal=True,
                                                  window=window), 20),
        "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=True,
                                                  window=window), 5),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20),
    }
    out["bound_ms"], out["bound_by"] = attention_bound_ms(shape, 2,
                                                          PEAK_BF16_FLOPS)
    out.update(attrs)
    print(f"[timing] flash_attn_fwd at B={B} S={S} H={H} KH={KH} hd={hd} "
          f"window={window} bf16 causal (tensor cores): "
          + ", ".join(f"{k} {v}" for k, v in out.items()))
    return out


def rglru_inputs(shape, dtype, device, seed):
    """a, u, h0 of one case: a in [0.5, 0.999) as tests/test_kernels.py
    draws it, or the model's decay a = exp(-8 softplus(1) sigmoid(z)) with
    the gated u = sqrt(1 - a^2) z'; a and u in ``dtype``, h0 f32 or None."""
    import torch
    import torch.nn.functional as F
    B, S, R, with_h0, model_a = shape
    g = torch.Generator(device).manual_seed(seed)
    z = torch.randn(B, S, R, generator=g, device=device)
    if model_a:
        a = torch.exp(-8 * F.softplus(torch.tensor(1.0, device=device))
                      * torch.sigmoid(z))
        u = torch.sqrt(1 - a * a) * torch.randn(B, S, R, generator=g,
                                                device=device)
    else:
        a = 0.5 + 0.499 * torch.rand(B, S, R, generator=g, device=device)
        u = z
    h0 = torch.randn(B, R, generator=g, device=device) if with_h0 else None
    return a.to(dtype), u.to(dtype), h0


def rglru_kernel_vs_plain(device) -> float:
    """Phase 2 for rglru_scan; returns the max abs error of both outputs at
    the serving shape with f32 a and u, the main path's case."""
    import torch
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    err = None
    for i, shape in enumerate(RGLRU_GRID + [RGLRU_SERVE]):
        for name in ("bfloat16", "float32"):
            a, u, h0 = rglru_inputs(shape, getattr(torch, name), device,
                                    seed=200 + i)
            hs, h_final = rglru_scan_fwd(a, u, h0)
            torch.cuda.synchronize(device)
            hs_ref, final_ref = rglru_scan_ref(a, u, h0)
            check(hs.dtype == u.dtype and hs.shape == u.shape
                  and h_final.dtype == torch.float32
                  and bool(torch.isfinite(hs).all())
                  and bool(torch.isfinite(h_final).all()), "bad rglru_scan output")
            tol = TOL[name] if name == "bfloat16" else RGLRU_TOL
            e_seq, excess_seq = excess_error(hs, hs_ref, tol)
            e_fin, excess_fin = excess_error(h_final, final_ref, RGLRU_TOL)
            print(f"[kernel] rglru_scan {name} (B,S,R,h0,model a)={shape}: "
                  f"min a {a.min().item():.3e}, max|err| h_seq {e_seq:.3e} "
                  f"(tol {tol:g} abs + rel), h_final {e_fin:.3e} "
                  f"(tol {RGLRU_TOL:g})")
            check(excess_seq <= 0 and excess_fin <= 0,
                  f"rglru_scan disagrees with plain at {shape} {name}")
            err = max(e_seq, e_fin)  # f32 last: the main path's case
    return err


def rglru_timing(device) -> dict:
    """Phase 3 for rglru_scan at the serving shape (f32 a and u, as the
    model's gates give them).  No single PyTorch call computes a linear
    recurrence: library_ms is null.  The bound counts a and u read once and
    h_seq and h_final written once; 2 flops per element."""
    import torch
    from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
    a, u, h0 = rglru_inputs(RGLRU_SERVE, torch.float32, device, seed=98)
    B, S, R = a.shape
    out = {
        "ms": time_ms(lambda: rglru_scan_fwd(a, u, h0), 50),
        "plain_ms": time_ms(lambda: rglru_scan_ref(a, u, h0), 3, warmup=1),
        "library_ms": None,
    }
    t_bytes = 4 * (3 * B * S * R + B * R) / PEAK_BYTES * 1e3
    t_ops = 2 * B * S * R / PEAK_F32_FLOPS * 1e3
    out["bound_ms"] = max(t_bytes, t_ops)
    out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    print(f"[timing] rglru_scan at B={B} S={S} R={R} f32 (no single PyTorch "
          "call computes it: library_ms null): "
          + ", ".join(f"{k} {v}" for k, v in out.items()))
    return out


def serve_and_check(device, arch: str) -> dict:
    """Phase 4 for one model: the main path, its launch counts (each
    kernel of ``PATHS[arch]`` that many times per prefill round, no other
    kernel), and in-model parity of kernel against plain.  Returns the
    launch counts."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import serve
    from repro_torch.models.lm import init_params

    cfg = ARCHS[arch]
    torch.cuda.reset_peak_memory_stats(device)
    LAUNCHES.clear()
    stats = serve.main(serve_argv(arch))
    launches = dict(LAUNCHES)
    stats["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    print("[serve] " + json.dumps(stats))
    print(f"[serve] launches during serving {arch}: {launches}")
    check(stats["arch"] == cfg.name, "serve did not run the full-width config")
    want = {k: n * stats["rounds"] for k, n in PATHS[arch].items()}
    check(launches == want, f"{arch}: expected launches {want}, saw {launches}")

    model = init_params(cfg, torch.Generator(device).manual_seed(0))
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, size=(BATCH, PROMPT))
    batch = {"tokens": torch.from_numpy(prompt).to(device)}
    if cfg.ssm or "rglru" in cfg.layer_kinds:
        (ssd_layer_parity if cfg.ssm else hybrid_layer_parity)(cfg, model, batch)
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        logit_parity(cfg32, model, batch, F32_LOGIT_ATOL, device)
        logit_parity(cfg, model, batch, None, device)  # printed, not gated
    else:
        logit_parity(cfg, model, batch, LOGIT_ATOL, device)
    del model
    torch.cuda.empty_cache()
    return launches


def prefill_logits(cfg, model, batch, impl: str):
    import torch
    from repro_torch.models.steps import make_prefill_step
    with torch.inference_mode():
        return make_prefill_step(cfg, impl=impl)(model, batch)[0][:, -1]


@contextlib.contextmanager
def ulp_noise_in_plain(cfg, device):
    """The plain path with one f32 ulp of relative noise in the f32 output of
    its SSD intra term (mamba2-780m) or of its RG-LRU scan (recurrentgemma-
    2b): the spread of the plain path against itself, a floor for kernel vs
    plain."""
    import torch
    if cfg.ssm:
        from repro_torch.kernels.ssd_scan import ref as module
        name = "ssd_chunk_ref"
    else:
        from repro_torch.kernels.rglru_scan import ops as module
        name = "rglru_scan_assoc"
    plain = getattr(module, name)
    g = torch.Generator(device).manual_seed(5)

    def noisy(*args, **kwargs):
        y, rest = plain(*args, **kwargs)
        noise = torch.randn(y.shape, generator=g, device=y.device)
        return y * (1 + 2 ** -23 * noise), rest

    setattr(module, name, noisy)
    try:
        yield
    finally:
        setattr(module, name, plain)


def logit_parity(cfg, model, batch, tol, device) -> None:
    """Last-position logits of one full-width prefill through the kernel and
    through the plain version; gated when ``tol`` is given."""
    import torch
    kern = prefill_logits(cfg, model, batch, "auto")
    plain = prefill_logits(cfg, model, batch, "reference")
    check(kern.shape == plain.shape == (BATCH, cfg.vocab)
          and bool(torch.isfinite(kern).all()),
          "prefill logits are not finite or of the wrong shape")
    diff = (kern - plain).abs().max().item()
    same = torch.equal(kern.argmax(-1), plain.argmax(-1))
    top2 = plain.topk(2, dim=-1).values
    gaps = [round(g, 4) for g in (top2[:, 0] - top2[:, 1]).tolist()]
    floor = ""
    if cfg.ssm or "rglru" in cfg.layer_kinds:
        with ulp_noise_in_plain(cfg, device):
            noisy = prefill_logits(cfg, model, batch, "reference")
        term = "SSD term" if cfg.ssm else "RG-LRU scan output"
        floor = (f", plain vs plain with one f32 ulp of noise in its {term} "
                 f"{(noisy - plain).abs().max().item():.4e}")
    print(f"[parity] {cfg.name} {cfg.compute_dtype} full-width prefill logits, "
          f"kernel vs plain: max|diff| {diff:.4e} (tol {tol or 'none: not gated'})"
          f"{floor}; |logit| max {plain.abs().max().item():.3f}, greedy tokens "
          f"equal: {same}, top-2 gaps {gaps}")
    if tol is not None:
        check(diff <= tol, "kernel and plain prefill logits disagree")
        check(same, "kernel and plain prefill pick different greedy tokens")

def ssd_layer_parity(cfg, model, batch) -> None:
    """Every layer's SSD, kernel against plain, from the same inputs: a
    prefill along the plain path that also runs the kernel path at each
    layer's SSD call and compares the two."""
    import torch
    from repro_torch.models import ssm
    plain_ssd = ssm.ssd
    worst = {"y": 0.0, "h_final": 0.0}
    layers = []

    def both(x, dt, A, B, C, D, *, chunk, impl):
        y_ref, h_ref = plain_ssd(x, dt, A, B, C, D, chunk=chunk, impl="reference")
        y, h = plain_ssd(x, dt, A, B, C, D, chunk=chunk, impl="auto")
        for what, got, ref, tol in (("y", y, y_ref, TOL["bfloat16"]),
                                    ("h_final", h, h_ref, SSD_TOL)):
            err, excess = excess_error(got, ref, tol)
            check(got.dtype == ref.dtype and bool(torch.isfinite(got).all())
                  and excess <= 0, f"layer {len(layers)}: SSD {what} of the "
                  f"kernel path disagrees with plain (max|err| {err:.3e})")
            worst[what] = max(worst[what], err)
        layers.append(x.dtype)
        return y_ref, h_ref

    ssm.ssd = both
    try:
        prefill_logits(cfg, model, batch, "reference")
    finally:
        ssm.ssd = plain_ssd
    check(len(layers) == cfg.n_layers and set(layers) == {torch.bfloat16},
          f"expected {cfg.n_layers} bf16 SSD calls, saw {layers}")
    print(f"[parity] {cfg.name} every layer's SSD, kernel vs plain on the plain "
          f"path's bf16 activations ({len(layers)} layers): max|err| y "
          f"{worst['y']:.3e} (tol {TOL['bfloat16']:g} abs + rel), h_final "
          f"{worst['h_final']:.3e} (tol {SSD_TOL:g})")


def hybrid_layer_parity(cfg, model, batch) -> None:
    """Every RG-LRU layer's scan and every attention layer's output, kernel
    against plain, from the same inputs: a prefill along the plain path that
    also runs the kernels at each layer's call and compares.  The scan's
    kernel is held against its oracle (``impl="sequential"``), its h_seq
    after the model's cast to the compute dtype."""
    import torch
    from repro_torch.models import layers, rglru
    plain_scan, plain_attn = rglru.rglru_scan, layers.flash_attention
    worst = {"h_seq": 0.0, "h_final": 0.0, "attention": 0.0}
    seen = {"rglru": 0, "attention": 0}
    cdt = getattr(torch, cfg.compute_dtype)

    def compare(what, got, ref, tol):
        err, excess = excess_error(got, ref, tol)
        check(got.dtype == ref.dtype and bool(torch.isfinite(got).all())
              and excess <= 0, f"{what} of the kernel path disagrees with plain "
              f"(max|err| {err:.3e})")
        worst[what] = max(worst[what], err)

    def scan_both(a, u, h0=None, *, impl):
        hs, h = plain_scan(a, u, h0, impl="auto")
        hs_ref, h_ref = plain_scan(a, u, h0, impl="sequential")
        compare("h_seq", hs.to(cdt), hs_ref.to(cdt), TOL[cfg.compute_dtype])
        compare("h_final", h, h_ref, RGLRU_TOL)
        seen["rglru"] += 1
        return plain_scan(a, u, h0, impl=impl)

    def attn_both(q, k, v, *, causal, window, impl):
        o_ref = plain_attn(q, k, v, causal=causal, window=window, impl=impl)
        o = plain_attn(q, k, v, causal=causal, window=window, impl="auto")
        compare("attention", o, o_ref, TOL[cfg.compute_dtype])
        seen["attention"] += 1
        return o_ref

    rglru.rglru_scan, layers.flash_attention = scan_both, attn_both
    try:
        prefill_logits(cfg, model, batch, "reference")
    finally:
        rglru.rglru_scan, layers.flash_attention = plain_scan, plain_attn
    want = {"rglru": PATHS[cfg.name]["rglru_scan"],
            "attention": PATHS[cfg.name]["flash_attn_fwd"]}
    check(seen == want, f"expected {want} layer calls, saw {seen}")
    print(f"[parity] {cfg.name} every layer, kernel vs plain on the plain "
          f"path's {cfg.compute_dtype} activations ({seen}): max|err| RG-LRU "
          f"h_seq {worst['h_seq']:.3e} after the cast (tol "
          f"{TOL[cfg.compute_dtype]:g} abs + rel), h_final "
          f"{worst['h_final']:.3e} (tol {RGLRU_TOL:g}), attention output "
          f"{worst['attention']:.3e} (tol {TOL[cfg.compute_dtype]:g})")


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
    spill_gate(ptxas_summary(logs["flash_attn_fwd"]))

    errs = kernel_vs_plain(device)
    ssd_err = ssd_kernel_vs_plain(device)
    rglru_err = rglru_kernel_vs_plain(device)
    timings = {shape: kernel_timing(device, shape)
               for shape in (SERVE_SHAPE, RG_SERVE_SHAPE)}
    ssd_time = ssd_timing(device)
    rglru_time = rglru_timing(device)
    launches = {arch: serve_and_check(device, arch) for arch in PATHS}

    flash_shapes = [
        {"shape": list(shape), "path": arch,
         "launches": launches[arch].get("flash_attn_fwd", 0),
         "max_abs_err": errs[shape], **timings[shape]}
        for shape, arch in ((SERVE_SHAPE, "qwen3-0.6b"),
                            (RG_SERVE_SHAPE, "recurrentgemma-2b"))]
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attn_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
        "design": "bf16: tensor cores (mma.sync m16n8k16 bf16 -> f32, ldmatrix "
                  "from swizzled shared memory, two cp.async K/V stages, P in "
                  "registers); f32: CUDA cores",
        # over both paths that run it; times at qwen3-0.6b's shape, each
        # serving shape's own under "shapes"
        "launches": sum(n.get("flash_attn_fwd", 0) for n in launches.values()),
        "max_abs_err": max(errs.values()), **timings[SERVE_SHAPE],
        "shapes": flash_shapes}, {
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:48",
        "launches": launches["mamba2-780m"].get("ssd_chunk", 0),
        "max_abs_err": ssd_err, **ssd_time}, {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:41",
        "launches": launches["recurrentgemma-2b"].get("rglru_scan", 0),
        "max_abs_err": rglru_err, **rglru_time}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))  # the smoke drives cuda:0 alone
    return 0


if __name__ == "__main__":
    sys.exit(main())
