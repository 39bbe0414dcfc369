#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any that fails ends the run with a non-zero exit:
  1. the card (``nvidia-smi`` name and power limit) and the build of every
     CUDA kernel from the checkout's sources (one nvcc per source, all
     started together), with nvcc's register, shared-memory and spill report;
  2. every kernel against its plain PyTorch version on the card:
     - flash_attn_fwd over the grid of ``tests/test_kernels.py`` plus a
       ragged length, a non-causal case and the serving shape, each in f32
       and bf16 (tolerances: f32 2e-5, bf16 8e-3, abs + rel);
     - ssd_chunk against ``ssd_chunk_ref`` over the grid of
       ``tests/test_kernels.py`` and mamba2-780m's serving shape (with that
       test's A and with the model's A), x, B and C in f32 and in bf16, both
       outputs (f32 on both sides: 2e-4 abs + rel); and the padded grid case
       through the whole ``ops.ssd`` against ``ssd_chunked_ref``;
  3. each kernel's time at its serving shape beside its plain version, one
     PyTorch library call computing the same function where there is one (a
     yardstick the port never calls) and the least time the card could take;
  4. the main paths, each with the launch counts set to 0 just before it and
     read just after: ``repro_torch.launch.serve`` serves 8 requests of
     full-width qwen3-0.6b, then of full-width mamba2-780m (random weights
     from a seed); after each, kernel against plain in the model: for
     qwen3-0.6b the logits of one prefill of the same weights; for
     mamba2-780m every layer's SSD output on the plain path's bf16
     activations, and the logits of one prefill in f32 compute (its bf16
     logits are printed beside the plain path's own spread, not gated);
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
BATCH, PROMPT = 4, 2048  # the traffic of both served models


def serve_argv(arch: str) -> list:
    return ["--arch", arch, "--no-reduced", "--requests", "8", "--batch",
            str(BATCH), "--prompt-len", str(PROMPT), "--max-new", "32"]


# Kernel-vs-plain logits of one full-width qwen3-0.6b prefill: both paths
# keep f32 softmax statistics and round each attention output to bf16, so they
# differ where a sum taken in another order rounds to the neighbouring bf16
# value (a relative step of 2**-8).  Such steps enter the residual stream in
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
SSM_F32_LOGIT_ATOL = 2e-3
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


def serve_and_check(device, arch: str, kernel: str) -> dict:
    """Phase 4 for one model: the main path, its launch counts (``kernel``
    once per layer per prefill round, no other kernel), and in-model
    parity of kernel against plain.  Returns the launch counts."""
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
    check(launches.get(kernel, 0) == cfg.n_layers * stats["rounds"],
          f"expected {cfg.n_layers} {kernel} launches per prefill round")
    check(all(n == 0 for k, n in launches.items() if k != kernel),
          f"{arch} launched a kernel of another path: {launches}")

    model = init_params(cfg, torch.Generator(device).manual_seed(0))
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, size=(BATCH, PROMPT))
    batch = {"tokens": torch.from_numpy(prompt).to(device)}
    if cfg.ssm:
        ssd_layer_parity(cfg, model, batch)
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        logit_parity(cfg32, model, batch, SSM_F32_LOGIT_ATOL, device)
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
def ulp_noise_in_plain_ssd(device):
    """The plain SSD intra term with one f32 ulp of relative noise: the
    spread of the plain path against itself, a floor for kernel vs plain."""
    import torch
    from repro_torch.kernels.ssd_scan import ref
    plain = ref.ssd_chunk_ref
    g = torch.Generator(device).manual_seed(5)

    def noisy(*args, **kwargs):
        y, chunk_in = plain(*args, **kwargs)
        noise = torch.randn(y.shape, generator=g, device=y.device)
        return y * (1 + 2 ** -23 * noise), chunk_in

    ref.ssd_chunk_ref = noisy
    try:
        yield
    finally:
        ref.ssd_chunk_ref = plain


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
    if cfg.ssm:
        with ulp_noise_in_plain_ssd(device):
            noisy = prefill_logits(cfg, model, batch, "reference")
        floor = (f", plain vs plain with one f32 ulp of noise in its SSD term "
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
    ssd_err = ssd_kernel_vs_plain(device)
    timing = kernel_timing(device)
    ssd_time = ssd_timing(device)
    launches = serve_and_check(device, "qwen3-0.6b", "flash_attn_fwd")
    ssd_launches = serve_and_check(device, "mamba2-780m", "ssd_chunk")

    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attn_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
        "launches": launches.get("flash_attn_fwd", 0), "max_abs_err": err,
        **timing}, {
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:48",
        "launches": ssd_launches.get("ssd_chunk", 0), "max_abs_err": ssd_err,
        **ssd_time}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))  # the smoke drives cuda:0 alone
    return 0


if __name__ == "__main__":
    sys.exit(main())
