#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any that fails ends the run with a non-zero exit:
  1. the card (``nvidia-smi`` name and power limit) and the build of every
     CUDA kernel from the checkout's sources (one nvcc per source, all
     started together), with nvcc's register, shared-memory and spill report;
     the run fails if a bf16 (tensor-core) flash or SSD instantiation, an
     f32 flash instantiation, a flash backward, SSD backward or RG-LRU
     backward instantiation spills;
  2. every kernel against its plain PyTorch version on the card:
     - flash_attn_fwd over the grid of ``tests/test_kernels.py`` plus a
       ragged length, a non-causal case, head_dim 256 (small, ragged and
       windowed, and with a window that bites), cases that straddle the
       tensor-core kernel's tiles, and both serving shapes (qwen3-0.6b's and
       recurrentgemma-2b's), each in f32 (the CUDA-core kernel) and bf16
       (the tensor-core kernel); tolerances f32 2e-5, bf16 8e-3, abs + rel;
     - ssd_chunk (the f32 path's CUDA-core kernel) against ``ssd_chunk_ref``
       over the grid of ``tests/test_kernels.py`` and mamba2-780m's serving
       shape (with that test's A and with the model's A), x, B and C in f32
       and in bf16, both outputs (f32 on both sides: 2e-4 abs + rel); and the
       padded grid case through the whole ``ops.ssd`` against
       ``ssd_chunked_ref``;
     - the bf16 path's kernels, ssd_chunk_state, ssd_state_pass and
       ssd_chunk_scan, each against its plain version (the cumsum to the
       bit; chunk_in, h_ins and h_final 2e-4; y one bf16 step, 8e-3), and
       the whole bf16 ``ops.ssd`` against ``ssd_chunked_ref`` (y 8e-3,
       h_final 2e-4), over that grid, the serving shape with both A, chunk 8
       (P 16, N 16), G = 2 and 3, chunks that are not a multiple of 16 (24,
       5), with and without h0;
     - rglru_scan against ``rglru_scan_ref`` over the grid of
       ``tests/test_kernels.py``, a ragged length, h0 None and
       recurrentgemma-2b's serving shape with the model's kind of decay, a
       and u in f32 and in bf16, both outputs (f32 1e-5, bf16 h_seq 8e-3);
     - the flash backward's kernels (flash_attn_bwd_pre, _dkdv, _dq) against
       ``attention_bwd_ref`` over flash_attn_fwd's grid plus qwen3-0.6b's
       training shape and recurrentgemma-2b's at batch 1 and 4, f32 and bf16
       (dq, dk, dv 1e-4 and 2e-2; D 1e-5), and the forward's log-sum-exp
       against ``lse_ref`` (1e-5); then bf16 at head_dim 256 with the dK/dV
       kernel's query walk cut into other numbers of parts than
       ``bwd_splits`` picks (1, 3, more parts than query tiles) at a ragged
       S, window 1, a window inside a tile, KH > 1 and the training shape;
     - rglru_scan_bwd against ``rglru_scan_bwd_ref`` over rglru_scan's grid
       and recurrentgemma-2b's training shape, with and without dh_final,
       f32 and bf16 (1e-5; bf16 da and du one bf16 step, 8e-3);
     - the SSD backward's kernels (ssd_bwd_dstate, ssd_bwd_state_pass,
       ssd_bwd_chunk: bf16 the tensor-core kernel of csrc/ssd_bwd_tc.cu,
       counted as ssd_bwd_chunk_tc, f32 ssd_bwd.cu's) each against its plain
       version from the same inputs over the bf16 path's grid and
       mamba2-780m's training shape, with and without h0 and dh_final, f32
       and bf16 (1e-4 and 2e-2, see SSD_BWD_TOL), with their launches;
     - ``SSDScan`` and ``RGLRUScan`` through ``ops.ssd`` and
       ``ops.rglru_scan`` with grad on, against autograd through the plain
       versions, with their launches (the SSD also at a ragged length, through
       the padding);
  3. each kernel's time at its serving shape beside its plain version, one
     PyTorch library call computing the same function where there is one (a
     yardstick the port never calls) and the least time the card could take;
     for flash_attn_fwd also the registers, local and shared bytes of the
     bf16 kernel; for the bf16 SSD path each kernel, the whole ``ops.ssd``
     beside the path it replaced (ssd_chunk and its PyTorch glue) and
     ``ssd_chunked_ref``, with the whole function's bound; for the flash
     backward each kernel, their sum, ``attention_bwd_ref`` and SDPA's
     backward (the yardstick) at the training shape, and the forward with
     and without its log-sum-exp, and the same at recurrentgemma-2b's
     training shape (head_dim 256) at batch 4 and at the cell's batch 1,
     with the dK/dV kernel's parts; rglru_scan_bwd and the SSD backward's
     kernels at their training shapes, each beside its plain version and its
     bound (ssd_bwd_dstate also beside ``torch.einsum`` of the prescaled dy
     and C, the one PyTorch call that computes its product; the bf16
     ssd_bwd_chunk_tc beside the CUDA-core kernel it replaced on the same
     bf16 inputs, and that kernel on f32 inputs, its live path), and the
     whole SSD backward;
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
     beside the plain path's own spread, not gated); then
     ``repro_torch.launch.train`` trains full-width qwen3-0.6b (batch 4 x
     2048, random weights) for a few steps, each step with 56 flash_attn_fwd
     launches (28 layers, and 28 again in the rematerialised recompute) and
     28 of each backward kernel, finite losses, then a checkpoint and a
     resume that starts at the saved step; kernel against plain in the
     model: one step's loss and every gradient leaf in f32 compute (gated),
     every layer's attention backward in bf16 (gated) and the bf16
     gradients end to end (printed, not gated); then the same launcher trains
     full-width mamba2-780m (batch 4 x 2048) and recurrentgemma-2b (batch
     1 x 2048, the largest of 1, 2, 4 under 70 GB) for 3 steps each with
     their launches per step (``TRAIN_PATHS``) and finite losses, and the
     same gates: one f32-compute step's loss and gradients (batch 1), every
     layer's SSD, RG-LRU and attention backward in bf16, the bf16 gradients
     printed;
  5. a JSON line per the kernel table, then the last line
     ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import collections
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
    "mamba2-780m": {"ssd_chunk_state": 48, "ssd_state_pass": 48,
                    "ssd_chunk_scan": 48},
    "recurrentgemma-2b": {"flash_attn_fwd": 8, "rglru_scan": 18},
}


def train_argv(arch: str, steps: int, *extra: str) -> list:
    return ["--arch", arch, "--no-reduced", "--batch", str(TRAIN_CELLS[arch][0]),
            "--seq", str(PROMPT), "--steps", str(steps), "--log-every", "1",
            *extra]


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
# The bf16 path (ssd_chunk_state, ssd_state_pass, ssd_chunk_scan) also at the
# reduced configs' (P, N, chunk) = (16, 16, 8), G = 2 and 3, chunks that are
# not a multiple of the kernels' 16-row tiles (24, 5), and one 512-row case of
# mamba2-780m's widths; each case with and without h0.
SSD_BF16_GRID = SSD_GRID + [
    (2, 48, 8, 16, 1, 16, 8, False),
    (1, 96, 4, 16, 2, 32, 24, True),
    (2, 64, 6, 32, 3, 16, 16, True),
    (1, 40, 2, 16, 1, 16, 5, True),
    (1, 512, 4, 64, 1, 128, 256, True),
]
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
# The flash backward (flash_attn_bwd_pre, _dkdv, _dq) against
# attention_bwd_ref from the same q, k, v, o, L and dO, abs + rel:
# - f32: 1e-4 on dq, dk and dv: both sides compute in f32 from the same
#   inputs, but a gradient sums up to S (dq) or G·S (dk, dv) terms, taken in
#   another order;
# - bf16: 2e-2, tests/test_kernels.py::_tol's bf16 attention bound: both
#   sides compute in f32 from the same bf16 inputs and round each output to
#   bf16 once (one step, 2**-8 relative), and the tensor-core kernels (hd 16
#   and 64) also round P and dS to bf16 as operands of their products: a
#   relative 2**-8 on each term of sums whose errors are of random sign;
# - D = rowsum(dO o O), f32 from the same inputs on both sides: 1e-5.
# The forward's log-sum-exp against lse_ref: 1e-5 (f32 sums of the same
# scores in another order, and the bf16 kernel's ex2.approx).
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
D_TOL = 1e-5
LSE_TOL = 1e-5
BWD_KERNEL_NAMES = ("flash_attn_bwd_pre", "flash_attn_bwd_dkdv",
                    "flash_attn_bwd_dq")
TRAIN_SHAPE = (4, 2048, 16, 8, 64, None, True)  # qwen3-0.6b training attention
# The training cells, (batch, steps) each, at 2048 tokens a row: batch 4 for
# qwen3-0.6b and mamba2-780m (20.7 GB at its peak); recurrentgemma-2b at
# batch 1 took 67.4-68.3 GB (NVIDIA H100 80GB HBM3, 700.00 W), so 1 is the
# largest of 1, 2 and 4 that stays under 70 GB.  qwen3-0.6b's run is
# followed by a checkpoint and resume, which take the same launcher path for
# every model.
TRAIN_CELLS = {"qwen3-0.6b": (4, 4), "mamba2-780m": (4, 3),
               "recurrentgemma-2b": (1, 3)}
# Launches per training step: each superblock's forward runs twice (the
# step's forward and the rematerialised recompute in the backward), each
# backward kernel once a layer.  qwen3-0.6b: 28 layers, each one superblock.
# mamba2-780m: 48 SSM layers, each one superblock.  recurrentgemma-2b: 8
# superblocks of (RG-LRU, RG-LRU, attention) and 2 RG-LRU tail layers
# outside any superblock, so 16 x 2 + 2 = 34 scans, 18 scan backwards, 16
# flash forwards, 8 of each flash backward.  mamba2-780m's bf16 backward
# runs the tensor-core ssd_bwd_chunk (counted as ssd_bwd_chunk_tc); its
# f32-compute gate the CUDA-core one (ssd_bwd_chunk, see grad_parity).
TRAIN_PATHS = {
    "qwen3-0.6b": {"flash_attn_fwd": 56, "flash_attn_bwd_pre": 28,
                   "flash_attn_bwd_dkdv": 28, "flash_attn_bwd_dq": 28},
    "mamba2-780m": {"ssd_chunk_state": 96, "ssd_state_pass": 96,
                    "ssd_chunk_scan": 96, "ssd_bwd_dstate": 48,
                    "ssd_bwd_state_pass": 48, "ssd_bwd_chunk_tc": 48},
    "recurrentgemma-2b": {"rglru_scan": 34, "rglru_scan_bwd": 18,
                          "flash_attn_fwd": 16, "flash_attn_bwd_pre": 8,
                          "flash_attn_bwd_dkdv": 8, "flash_attn_bwd_dq": 8},
}
# The batch of the gradient gates, at full width and depth: qwen3-0.6b's
# training batch; 1 for the recurrent models, since three f32 gradient sets
# of recurrentgemma-2b's 2.89 B parameters are 35 GB and the plain SSD path
# at batch 4 holds (4, 8, 48, 256, 256) f32 score tensors a layer.
GRAD_BATCH = {"qwen3-0.6b": BATCH, "mamba2-780m": 1, "recurrentgemma-2b": 1}
RG_TRAIN_SHAPE = (4, 2048, 10, 1, 256, 2048, True)  # recurrentgemma-2b's attention
RG_TRAIN_SHAPE_B1 = (1,) + RG_TRAIN_SHAPE[1:]  # ... at the training cell's batch
# bf16 head_dim-256 cases with the dK/dV kernel's query walk cut into a
# given number of parts, (shape, splits): a ragged S, window 1 and more
# parts than query tiles, a window inside a tile with KH > 1, unsplit, a
# non-causal ragged S, and the training shapes at other part counts than
# bwd_splits picks (8 at batch 1, 2 at batch 4).
SPLIT_GRID = [
    ((1, 2049, 10, 1, 256, 2048, True), 3),
    ((1, 65, 4, 1, 256, 1, True), 8),
    ((1, 127, 4, 2, 256, 40, True), 3),
    ((1, 300, 10, 1, 256, 128, True), 1),
    ((2, 129, 2, 1, 256, None, False), 5),
    (RG_TRAIN_SHAPE_B1, 1),
    (RG_TRAIN_SHAPE_B1, 3),
    (RG_TRAIN_SHAPE, 8),
]
# rglru_scan_bwd against rglru_scan_bwd_ref: the same rounded sum and product
# in the same order, so f32 agrees exactly (1e-5 abs + rel, RGLRU_TOL); bf16
# da and du are rounded to bf16 once on both sides, one step (8e-3); dh0 is
# f32.  The SSD backward's kernels against their plain versions from the
# same inputs: both sides compute in f32 and differ in the order of sums; dS,
# the chunk-end term, dx, ddt, dA, dB, dC and dD each sum over up to a
# chunk's rows (dA and dD over the whole sequence, dB and dC also over the
# heads of a group), so their tolerance is taken relative to the gradient's
# largest magnitude, |err| <= tol + tol max|ref|, except dA's: it sums dt . rc
# (rc the reverse cumsum of cum's gradient) over every row of the sequence,
# terms far larger than dA itself (at (1, 512, 4, 64, 1, 128, 256) kernel and
# plain version, both f32, differed by 1.6e-2, more than 1e-4 of max|dA|), so
# its scale is the sum of its terms' magnitudes (``chunk_bwd_ref``'s dA_scale);
# dchunk_in and dh0 come from an elementwise recurrence over the chunks: abs +
# rel.  f32 inputs 1e-4;
# bf16 inputs 2e-2 (tests/test_kernels.py::_tol's bf16 bound; dx is written
# in bf16, one rounding).
SSD_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SSD_BWD_SCALED = ("dS", "end", "dx", "ddt", "dA", "dB", "dC", "dD")
SSD_BWD_GRID = SSD_BF16_GRID + [SSD_SERVE + (True,)]  # the last: training
SSD_BWD_KERNELS = ("ssd_bwd_dstate", "ssd_bwd_state_pass", "ssd_bwd_chunk")
SSD_BWD_TC = "ssd_bwd_chunk_tc"  # the bf16 ssd_bwd_chunk's launches
# The physical mode (``repro_torch.cluster.localcloud``), as
# examples/train_cluster.py runs it but at full width and depth: Eva's
# three-type local catalog, the example's jobs (id, workload, model, steps,
# (gpu, cpu, ram) demand), its 3 s rounds, and the reference worker's batch
# of 2 x 32 tokens.  Each job's standalone steps/s is measured first, from a
# solo run of the port's worker (CALIBRATION_STEPS, the first
# CALIBRATION_WARMUP not timed).
CLUSTER_TYPES = [("local.large", "c7i", (0, 4, 16), 1.0),
                 ("local.small", "c7i", (0, 2, 8), 0.55),
                 ("local.micro", "c7i", (0, 1, 4), 0.30)]
CLUSTER_JOBS = [(1, 7, "smollm-135m", 40, (0, 1, 4)),
                (2, 6, "qwen3-0.6b", 40, (0, 1, 4)),
                (3, 9, "mamba2-780m", 20, (0, 2, 8))]
CLUSTER_ROUND_S = 3.0
CLUSTER_TIMEOUT_S = 480
CALIBRATION_STEPS, CALIBRATION_WARMUP = 10, 2
# The kernels' shapes there: attention of smollm-135m (9 heads, 3 KV heads)
# and qwen3-0.6b at 2 x 32; mamba2-780m's SSD at 2 x 32, padded to one
# 256-row chunk (``ssd_scan/ops.py``), with the model's A.
CLUSTER_SHAPES = [(2, 32, 9, 3, 64, None, True), (2, 32, 16, 8, 64, None, True)]
CLUSTER_SSD = (2, 256, 48, 64, 1, 128, 256, True)

# One training step's loss and gradients, kernel path against the plain
# path (impl="reference": autograd through attention_chunked), in f32
# compute from the same weights and batch.  The paths differ only in the
# order of f32 sums inside attention (relative ~1e-7, phase 2), which the
# 28 layers carry into every gradient; the gate starts from the f32 logits
# gate's 2e-3, taken relative to each leaf's largest gradient (gradients
# have no unit scale), and the plain path's own spread under one f32 ulp of
# noise in its attention output is printed beside it.
GRAD_RTOL = 2e-3


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


def spill_gate(logs: dict) -> None:
    """Fails the run unless every bf16 (tensor-core) instantiation reports 0
    bytes of spill stores and loads in ptxas's report: the flash kernel's,
    one per head_dim its wrapper takes, and the SSD path's, ssd_chunk_state,
    ssd_chunk_scan and the bf16 ssd_bwd_dstate and ssd_bwd_chunk at each
    (P, N) their wrappers take and ssd_state_pass; and the same of the f32
    flash kernel, of the
    flash backward's three kernels, one per head_dim and type (bf16 at
    head_dim 256: the eight-warp kernels), of the SSD backward's three, one
    per (P, N) and type, and of the RG-LRU backward, one per type."""
    import re
    from repro_torch.kernels.flash_attention.kernel import (
        HEAD_DIMS, TC_BWD_HEAD_DIMS, WIDE_BWD_HEAD_DIMS)
    from repro_torch.kernels.ssd_scan.kernel import PN_PAIRS
    n_tc, n_wide = len(TC_BWD_HEAD_DIMS), len(WIDE_BWD_HEAD_DIMS)
    # the tensor-core forward once without L (served) and once with it
    wanted = (("flash_attn_fwd", "flash_attn_fwd_tc_kernel", 2 * len(HEAD_DIMS)),
              ("flash_attn_fwd", "flash_attn_fwd_simt_kernel", len(HEAD_DIMS)),
              ("flash_attn_bwd", "flash_attn_bwd_pre_kernel", 2 * len(HEAD_DIMS)),
              *(("flash_attn_bwd", f"flash_attn_bwd_{name}_kernel",
                 2 * len(HEAD_DIMS) - n_tc) for name in ("dkdv", "dq")),
              *(("flash_attn_bwd", f"flash_attn_bwd_{name}_tc_kernel",
                 n_tc - n_wide) for name in ("dkdv", "dq")),
              *(("flash_attn_bwd", f"flash_attn_bwd_{name}_wide_kernel", n_wide)
                for name in ("dkdv", "dq")),
              ("ssd_bf16", "ssd_chunk_state_kernel", len(PN_PAIRS)),
              ("ssd_bf16", "ssd_chunk_scan_kernel", len(PN_PAIRS)),
              ("ssd_bf16", "ssd_state_pass_kernel", 1),
              ("ssd_bf16", "ssd_bwd_dstate_tc_kernel", len(PN_PAIRS)),
              ("ssd_bwd_tc", "ssd_bwd_chunk_tc_kernel", len(PN_PAIRS)),
              # the backwards of the recurrent blocks, both input types each
              ("ssd_bwd", "ssd_bwd_dstate_kernel", 2 * len(PN_PAIRS)),
              ("ssd_bwd", "ssd_bwd_chunk_kernel", 2 * len(PN_PAIRS)),
              ("ssd_bwd", "ssd_bwd_state_pass_kernel", 1),
              ("rglru_scan", "rglru_scan_bwd_kernel", 2))
    for source, kernel, count in wanted:
        tc = [ln for ln in ptxas_summary(logs[source]) if kernel in ln]
        check(len(tc) == count, f"expected {count} {kernel} instantiations in "
              f"ptxas's report, found {len(tc)}")
        for ln in tc:
            found = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                              ln)
            check(found is not None and found.groups() == ("0", "0"),
                  f"an instantiation spills or was not reported: {ln}")


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
    """Phase 2; returns the max abs error at each serving shape and each
    physical-mode shape in bf16."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ref import attention_ref
    errs = {}
    for i, shape in enumerate(GRID + GRID_HD256 + [SERVE_SHAPE, RG_SERVE_SHAPE]
                              + CLUSTER_SHAPES):
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
    return {shape: errs[shape] for shape in [SERVE_SHAPE, RG_SERVE_SHAPE]
            + CLUSTER_SHAPES}


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


def ssd_bf16_vs_plain(device) -> dict:
    """Phase 2 for the bf16 path: each kernel against its plain version,
    and the whole ``ops.ssd`` against ``ssd_chunked_ref`` with its launches
    (one of each kernel, none of ssd_chunk); returns each kernel's max abs
    error at the serving shape with the model's A (the main path's case),
    and under "physical mode" at CLUSTER_SSD."""
    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.ssd_scan.kernel import (ssd_chunk_scan,
                                                     ssd_chunk_state,
                                                     ssd_state_pass)
    from repro_torch.kernels.ssd_scan.ops import ssd
    from repro_torch.kernels.ssd_scan.ref import (chunk_cumsum, chunk_scan_ref,
                                                  chunk_state_ref, pass_states)
    errs, by_case = {}, {}
    cases = SSD_BF16_GRID + [SSD_SERVE + (False,), SSD_SERVE + (True,),
                             CLUSTER_SSD]
    for i, shape in enumerate(cases):
        for with_h0 in (True, False):  # h0 None last: the main path's case
            x, dt, A, B, C, D = ssd_inputs(shape, torch.bfloat16, device,
                                           seed=300 + i)
            Bt, S, H, P, G, N, chunk = shape[:7]
            h0 = torch.randn(Bt, H, P, N, device=device) if with_h0 else None
            cum = chunk_cumsum(dt, A, chunk)
            got, ref = {}, {}
            got["chunk_in"], got["cum"] = ssd_chunk_state(x, dt, A, B,
                                                          chunk=chunk)
            got["h_ins"], got["h_final"] = ssd_state_pass(got["chunk_in"], cum,
                                                          h0, chunk=chunk)
            got["y"] = ssd_chunk_scan(x, dt, cum, B, C, D, got["h_ins"],
                                      chunk=chunk)
            torch.cuda.synchronize(device)
            # each kernel from the same inputs as its plain version
            ref["cum"] = cum
            ref["chunk_in"] = chunk_state_ref(x, dt, cum, B, chunk=chunk)
            ref["h_ins"], ref["h_final"] = pass_states(
                got["chunk_in"], torch.exp(cum[:, chunk - 1::chunk]), h0)
            ref["y"] = chunk_scan_ref(x, dt, cum, B, C, D, got["h_ins"],
                                      chunk=chunk)
            LAUNCHES.clear()
            got["whole y"], got["whole h_final"] = ssd(x, dt, A, B, C, D,
                                                       chunk=chunk, h0=h0)
            torch.cuda.synchronize(device)
            launches = dict(LAUNCHES)
            ref["whole y"], ref["whole h_final"] = ssd(x, dt, A, B, C, D,
                                                       chunk=chunk, h0=h0,
                                                       impl="reference")
            line = []
            for what in got:
                # the cumsum adds in PyTorch's order with its roundings: to
                # the bit
                tol = {"y": TOL["bfloat16"], "cum": 0.0}.get(what.split()[-1],
                                                           SSD_TOL)
                o, r = got[what], ref[what]
                check(o.dtype == r.dtype and o.shape == r.shape
                      and bool(torch.isfinite(o).all()), f"bad {what}")
                e, excess = excess_error(o, r, tol)
                check(excess <= 0, f"bf16 SSD {what} disagrees with plain at "
                      f"{shape} h0={with_h0}: max|err| {e:.3e} (tol {tol:g})")
                errs[what] = e
                line.append(f"{what} {e:.3e}")
            check(launches == {"ssd_chunk_state": 1, "ssd_state_pass": 1,
                               "ssd_chunk_scan": 1},
                  f"bf16 ops.ssd launched {launches}")
            print(f"[kernel] ssd bf16 (Bt,S,H,P,G,N,chunk,model A)={shape} "
                  f"h0={with_h0}: min cum {cum.min().item():.1f}, max|err| "
                  + ", ".join(line) + f" (tol y {TOL['bfloat16']:g}, cum 0, "
                  f"the rest {SSD_TOL:g}, abs + rel)")
            by_case[shape] = dict(errs)  # h0 None last

    def per_kernel(e):
        return {"ssd_chunk_state": max(e["cum"], e["chunk_in"]),
                "ssd_state_pass": max(e["h_ins"], e["h_final"]),
                "ssd_chunk_scan": e["y"]}
    return {**per_kernel(by_case[SSD_SERVE + (True,)]),
            "physical mode": per_kernel(by_case[CLUSTER_SSD])}


def bound(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple:
    """(least ms, "bytes" or "operations") for this many bytes and flops."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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
    return bound(nbytes, flops, peak_flops)


def ssd_bf16_bounds(shape) -> dict:
    """Least ms of each bf16 kernel and of the whole ``ops.ssd`` at ``shape``
    (bf16 x, B, C; f32 dt, cum, chunk_in, h_ins, h_final): each input read
    once, each output written once; the function's products once (the hi +
    lo split doubles three of them in the kernels; the bound does not
    count that)."""
    Bt, S, H, P, G, N, Q = shape
    nc = S // Q
    x, bc, f32 = 2 * Bt * S * H * P, 2 * Bt * S * G * N, 4 * Bt * S * H
    # ssd_chunk_state reads dt and A and writes cum and chunk_in; the other
    # two read cum
    states = 4 * Bt * nc * H * P * N
    causal = Q * (Q + 1) // 2  # (q, k) pairs a chunk keeps
    cb_flops = Bt * nc * G * causal * 2 * N       # C.B^T once per group
    intra = Bt * nc * H * causal * 2 * P           # scores . x
    carry = Bt * nc * H * 2 * Q * N * P            # C . h_in
    state = Bt * nc * H * 2 * Q * P * N            # (x w)^T . B
    return {
        "ssd_chunk_state": bound(x + 2 * f32 + 4 * H + bc + states, state),
        "ssd_state_pass": bound(2 * states + 4 * Bt * nc * H
                                + 4 * Bt * H * P * N, 2 * Bt * nc * H * P * N,
                                PEAK_F32_FLOPS),
        "ssd_chunk_scan": bound(2 * x + 2 * f32 + 2 * bc + 4 * H + states,
                                cb_flops + intra + carry),
        # x, dt, cum, B and C read once, y and h_final written once
        "ops.ssd": bound(2 * x + 2 * f32 + 2 * bc + 4 * Bt * H * P * N,
                         cb_flops + intra + carry + state),
    }


def ssd_bf16_timing(device) -> dict:
    """Phase 3 for the bf16 path at the serving shape (model A): each kernel
    beside its plain version and its bound, then the whole bf16 ``ops.ssd``
    beside the path it replaced (``ops._intra_then_pass``: ssd_chunk and its
    PyTorch glue) and ``ssd_chunked_ref``, in this run.  No single PyTorch
    call computes any of them: library_ms null."""
    import torch
    from repro_torch.kernels.ssd_scan import kernel, ops
    from repro_torch.kernels.ssd_scan.ref import (chunk_cumsum, chunk_scan_ref,
                                                  chunk_state_ref, pass_states,
                                                  ssd_chunked_ref)
    x, dt, A, B, C, D = ssd_inputs(SSD_SERVE + (True,), torch.bfloat16, device,
                                   seed=99)
    chunk = SSD_SERVE[6]
    cum = chunk_cumsum(dt, A, chunk)
    chunk_in, _ = kernel.ssd_chunk_state(x, dt, A, B, chunk=chunk)
    h_ins, _ = kernel.ssd_state_pass(chunk_in, cum, chunk=chunk)
    decay = torch.exp(cum[:, chunk - 1::chunk])
    runs = {
        "ssd_chunk_state": (
            lambda: kernel.ssd_chunk_state(x, dt, A, B, chunk=chunk),
            lambda: chunk_state_ref(x, dt, chunk_cumsum(dt, A, chunk), B,
                                    chunk=chunk)),
        "ssd_state_pass": (
            lambda: kernel.ssd_state_pass(chunk_in, cum, chunk=chunk),
            lambda: pass_states(chunk_in, decay)),
        "ssd_chunk_scan": (
            lambda: kernel.ssd_chunk_scan(x, dt, cum, B, C, D, h_ins,
                                          chunk=chunk),
            lambda: chunk_scan_ref(x, dt, cum, B, C, D, h_ins, chunk=chunk)),
    }
    bounds = ssd_bf16_bounds(SSD_SERVE)
    out = {}
    for name, (fast, plain) in runs.items():
        out[name] = {"ms": time_ms(fast, 20),
                     "plain_ms": time_ms(plain, 3, warmup=1),
                     "library_ms": None}
        out[name]["bound_ms"], out[name]["bound_by"] = bounds[name]
        if name in ("ssd_chunk_state", "ssd_chunk_scan"):
            out[name].update(kernel.attributes(name, *SSD_SERVE[3:6:2]))
        print(f"[timing] {name} at Bt=4 S=2048 H=48 P=64 G=1 N=128 chunk=256 "
              "bf16 (no single PyTorch call computes it: library_ms null): "
              + ", ".join(f"{k} {v}" for k, v in out[name].items()))
    whole = {
        "ms": time_ms(lambda: ops.ssd(x, dt, A, B, C, D, chunk=chunk), 20),
        "replaced_ms": time_ms(lambda: ops._intra_then_pass(
            x, dt, A, B, C, D, chunk=chunk), 10),
        "plain_ms": time_ms(lambda: ssd_chunked_ref(x, dt, A, B, C, D,
                                                    chunk=chunk), 3, warmup=1),
    }
    whole["bound_ms"], whole["bound_by"] = bounds["ops.ssd"]
    print("[timing] whole bf16 ops.ssd at the same shape (ms; replaced_ms: "
          "ssd_chunk and its PyTorch glue, the bf16 path before; plain_ms: "
          "ssd_chunked_ref): " + ", ".join(f"{k} {v}" for k, v in whole.items()))
    out["ssd_chunk_scan"]["whole_ops_ssd"] = whole
    return out


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


def visible_pairs(shape) -> int:
    """(query, key) pairs of one (batch, head) that the masks keep."""
    B, S, H, KH, hd, window, causal = shape
    pairs = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        hi = i + 1 if causal else S
        pairs += hi - lo
    return pairs


def attention_bound_ms(shape, dtype_bytes: int, peak_flops: float) -> tuple:
    """Least time for this run's attention: each of q, k, v, o moved once,
    4 * hd flops per (query, key) pair the masks keep."""
    B, S, H, KH, hd, window, causal = shape
    flops = 4 * hd * B * H * visible_pairs(shape)
    nbytes = dtype_bytes * (2 * B * S * H * hd + 2 * B * S * KH * hd)
    return bound(nbytes, flops, peak_flops)


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
    out["bound_ms"], out["bound_by"] = bound(4 * (3 * B * S * R + B * R),
                                             2 * B * S * R, PEAK_F32_FLOPS)
    print(f"[timing] rglru_scan at B={B} S={S} R={R} f32 (no single PyTorch "
          "call computes it: library_ms null): "
          + ", ".join(f"{k} {v}" for k, v in out.items()))
    return out


def bwd_kernel_vs_plain(device) -> dict:
    """Phase 2 for the flash backward: the forward's log-sum-exp against
    ``lse_ref``, then each backward kernel against its plain version from
    the same q, k, v, o, L and dO (D against rowsum(dO o O), dq, dk and dv
    against ``attention_bwd_ref``), over flash_attn_fwd's grid and the
    training shapes, f32 and bf16, the dK/dV kernel split as ``bwd_splits``
    picks; then bf16 over SPLIT_GRID with the parts given.  Returns, by
    training and physical-mode shape, the max abs errors in bf16 (the main
    paths' cases)."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import (BWD_KERNELS,
                                                            bwd_buffers,
                                                            flash_attention_fwd,
                                                            launch_bwd)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         lse_ref)
    check(BWD_KERNELS == BWD_KERNEL_NAMES, f"backward kernels {BWD_KERNELS}")
    errs, by_shape = {}, {}
    # (seed, shape, type, parts): a shape's seed is its place in the grid
    cases = [(i, shape, name, None) for i, shape in enumerate(
        GRID + GRID_HD256 + [TRAIN_SHAPE, RG_TRAIN_SHAPE, RG_TRAIN_SHAPE_B1]
        + CLUSTER_SHAPES)
        for name in ("float32", "bfloat16")]
    cases += [(200 + j, shape, "bfloat16", splits)
              for j, (shape, splits) in enumerate(SPLIT_GRID)]
    for i, shape, name, splits in cases:
        dtype = getattr(torch, name)
        q, k, v = qkv(shape, dtype, device, seed=400 + i)
        do = torch.randn(q.shape, generator=torch.Generator(device)
                         .manual_seed(500 + i), device=device).to(dtype)
        B, S, H, KH, hd, window, causal = shape
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     return_lse=True)
        bufs = bwd_buffers(q, k, v, o, lse, do, window=window,
                           splits=splits)
        for kernel in BWD_KERNELS:
            launch_bwd(kernel, bufs, causal=causal, window=window)
        torch.cuda.synchronize(device)
        ref = dict(zip(("dq", "dk", "dv"), attention_bwd_ref(
            q, k, v, o, lse, do, causal=causal, window=window)))
        ref["delta"] = (do.float() * o.float()).sum(-1).transpose(1, 2)
        ref["lse"] = lse_ref(q, k, causal=causal, window=window)
        line = []
        for what in ("lse", "delta", "dq", "dk", "dv"):
            tol = {"lse": LSE_TOL, "delta": D_TOL}.get(what, BWD_TOL[name])
            got = bufs[what]
            check(got.dtype == ref[what].dtype and got.shape == ref[what].shape
                  and bool(torch.isfinite(got).all()), f"bad backward {what}")
            e, excess = excess_error(got, ref[what], tol)
            check(excess <= 0, f"flash backward {what} disagrees with plain "
                  f"at {shape} {name}: max|err| {e:.3e} (tol {tol:g})")
            errs[what] = e
            line.append(f"{what} {e:.3e}")
        print(f"[kernel] flash backward {name} B={B} S={S} H={H} KH={KH} "
              f"hd={hd} window={window} causal={causal} dK/dV parts "
              f"{bufs['splits']}{'' if splits else ' (bwd_splits)'}: max|err| "
              + ", ".join(line) + f" (tol L {LSE_TOL:g}, D {D_TOL:g}, "
              f"gradients {BWD_TOL[name]:g}, abs + rel)")
        if splits is None and name == "bfloat16" and shape in [
                TRAIN_SHAPE, RG_TRAIN_SHAPE, RG_TRAIN_SHAPE_B1] + CLUSTER_SHAPES:
            by_shape[shape] = {
                "lse": errs["lse"], "flash_attn_bwd_pre": errs["delta"],
                "flash_attn_bwd_dkdv": max(errs["dk"], errs["dv"]),
                "flash_attn_bwd_dq": errs["dq"]}
    return by_shape


def rglru_bwd_vs_plain(device) -> float:
    """Phase 2 for rglru_scan_bwd: against ``rglru_scan_bwd_ref`` from the
    same a, f32 states (the forward kernel's), h0, dh_seq and dh_final, over
    rglru_scan's grid and the training shape, with and without dh_final.
    Returns the max abs error at the training shape in f32 (the model's
    gates are f32: the main path's case)."""
    import torch
    from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_bwd,
                                                       rglru_scan_fwd)
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref
    err = None
    for i, shape in enumerate(RGLRU_GRID + [RGLRU_SERVE]):
        for name in ("bfloat16", "float32"):
            for with_dhf in (True, False):
                a, u, h0 = rglru_inputs(shape, getattr(torch, name), device,
                                        seed=600 + i)
                B, S, R = a.shape
                g = torch.Generator(device).manual_seed(700 + i)
                dh = torch.randn(B, S, R, generator=g, device=device).to(a.dtype)
                dhf = torch.randn(B, R, generator=g, device=device) \
                    if with_dhf else None
                _, _, h_state = rglru_scan_fwd(a, u, h0, return_state=True)
                got = rglru_scan_bwd(a, h_state, h0, dh, dhf)
                torch.cuda.synchronize(device)
                first = torch.zeros_like(h_state[:, :1]) if h0 is None \
                    else h0[:, None]
                ref = rglru_scan_bwd_ref(a, torch.cat([first, h_state[:, :-1]], 1),
                                         dh, dhf)
                errs = []
                for what, o, r in zip(("da", "du", "dh0"), got, ref):
                    tol = TOL[name] if name == "bfloat16" and what != "dh0" \
                        else RGLRU_TOL
                    check(o.dtype == r.dtype and o.shape == r.shape
                          and bool(torch.isfinite(o).all()), f"bad {what}")
                    e, excess = excess_error(o, r, tol)
                    check(excess <= 0, f"rglru_scan_bwd {what} disagrees with "
                          f"plain at {shape} {name} dh_final={with_dhf}: "
                          f"max|err| {e:.3e} (tol {tol:g})")
                    errs.append(e)
                print(f"[kernel] rglru_scan_bwd {name} (B,S,R,h0,model a)={shape} "
                      f"dh_final={with_dhf}: max|err| da {errs[0]:.3e}, du "
                      f"{errs[1]:.3e}, dh0 {errs[2]:.3e} (tol f32 {RGLRU_TOL:g}, "
                      f"bf16 da and du {TOL['bfloat16']:g}, abs + rel)")
                if with_dhf:
                    err = max(errs)  # f32 last: the main path's case
    return err


def ssd_bwd_case(shape, dtype, device, seed, with_h0, with_dhf):
    """The forward's saved tensors (plain versions, f32) and a dy, dh_final
    of one case: (x, dt, A, B, C, D, cum, h_ins, dy, dh_final)."""
    import torch
    from repro_torch.kernels.ssd_scan.ref import (chunk_cumsum, pass_states,
                                                  ssd_chunk_ref)
    x, dt, A, B, C, D = ssd_inputs(shape, dtype, device, seed)
    Bt, S, H, P, G, N, chunk = shape[:7]
    g = torch.Generator(device).manual_seed(seed + 1)
    h0 = torch.randn(Bt, H, P, N, generator=g, device=device) if with_h0 else None
    dy = torch.randn(x.shape, generator=g, device=device).to(dtype)
    dhf = torch.randn(Bt, H, P, N, generator=g, device=device) \
        if with_dhf else None
    cum = chunk_cumsum(dt, A, chunk)
    _, chunk_in = ssd_chunk_ref(x, dt, cum, B, C, chunk=chunk)
    h_ins, _ = pass_states(chunk_in, torch.exp(cum[:, chunk - 1::chunk]), h0)
    return x, dt, A, B, C, D, cum, h_ins, dy, dhf


def ssd_bwd_check(what, got, ref, name, where, scale=None) -> float:
    """One SSD backward output against its plain version (SSD_BWD_TOL,
    scaled to the largest |ref| for SSD_BWD_SCALED, or to ``scale`` where
    given); returns max|err|."""
    import torch
    tol = SSD_BWD_TOL[name]
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          f"bad SSD backward {what} at {where}")
    d = (got.float() - ref.float()).abs()
    if scale is None:
        scale = ref.float().abs().max() if what in SSD_BWD_SCALED \
            else ref.float().abs()
    excess = (d - tol - tol * scale).max().item()
    check(excess <= 0, f"SSD backward {what} disagrees with plain at {where}: "
          f"max|err| {d.max().item():.3e} (tol {tol:g})")
    return d.max().item()


def ssd_bwd_vs_plain(device) -> dict:
    """Phase 2 for the SSD backward: each kernel against its plain version
    from the same inputs (ssd_bwd_dstate against ``chunk_dstate_ref``,
    ssd_bwd_state_pass against ``state_pass_bwd_ref`` from the kernel's dS,
    ssd_bwd_chunk against ``chunk_bwd_ref`` from the kernel's dchunk_in and
    chunk-end term), over the bf16 path's grid and the training shape (the
    model's A), with and without h0 and dh_final, f32 and bf16 x, B, C, dy,
    each kernel launched once (bf16: the tensor-core ssd_bwd_chunk, counted
    as ssd_bwd_chunk_tc), and at the physical mode's CLUSTER_SSD in bf16.  Returns
    each kernel's max abs error at the training shape, no h0 or dh_final:
    bf16 (the main path's case), and ssd_bwd_chunk's in f32 (the
    f32-compute gate's); under "physical mode" the bf16 errors at
    CLUSTER_SSD."""
    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.ssd_scan.kernel import (bwd_kernels, ssd_bwd_chunk,
                                                     ssd_bwd_dstate,
                                                     ssd_bwd_state_pass)
    from repro_torch.kernels.ssd_scan.ref import (chunk_bwd_ref,
                                                  chunk_dstate_ref,
                                                  state_pass_bwd_ref)
    errs, by_case = {}, {}
    for i, shape in enumerate(SSD_BWD_GRID + [CLUSTER_SSD]):
        combos = ((True, True), (False, False)) if shape[1] >= 2048 else \
            ((True, True), (True, False), (False, True), (False, False))
        # the physical mode's jobs compute in bf16, so its shape takes the
        # bf16 kernels alone (in f32 there, kernel and plain each lie up to
        # 2.5e-4 of dA_scale from float64, past the f32 dA gate's 1e-4:
        # tools/ssd_bwd_f64.py)
        for name in ("bfloat16",) if shape == CLUSTER_SSD else \
                ("float32", "bfloat16"):
            for with_h0, with_dhf in combos:
                x, dt, A, B, C, D, cum, h_ins, dy, dhf = ssd_bwd_case(
                    shape, getattr(torch, name), device, 800 + i, with_h0,
                    with_dhf)
                chunk = shape[6]
                got, ref = {}, {}
                LAUNCHES.clear()
                got["dS"] = ssd_bwd_dstate(dy, cum, C, chunk=chunk)
                got["dchunk_in"], got["dh0"], got["end"] = ssd_bwd_state_pass(
                    got["dS"], cum, h_ins, dhf, chunk=chunk)
                outs = ssd_bwd_chunk(x, dt, A, cum, B, C, D, dy, h_ins,
                                     got["dchunk_in"], got["end"], chunk=chunk)
                got.update(zip(("dx", "ddt", "dA", "dB", "dC", "dD"), outs))
                torch.cuda.synchronize(device)
                launched = dict(LAUNCHES)
                check(launched == dict.fromkeys(bwd_kernels(x.dtype), 1),
                      f"the SSD backward at {shape} {name} launched {launched}")
                ref["dS"] = chunk_dstate_ref(dy, cum, C, chunk=chunk)
                ref["dchunk_in"], ref["dh0"], ref["end"] = state_pass_bwd_ref(
                    got["dS"], cum, h_ins, dhf, chunk=chunk)
                *grads, dA_scale = chunk_bwd_ref(
                    x, dt, A, cum, B, C, D, dy, h_ins, got["dchunk_in"],
                    got["end"], chunk=chunk, dA_scale=True)
                ref.update(zip(("dx", "ddt", "dA", "dB", "dC", "dD"), grads))
                check(got["dx"].dtype == x.dtype, "dx is not in x's dtype")
                where = f"{shape} {name} h0={with_h0} dh_final={with_dhf}"
                line = {w: ssd_bwd_check(w, got[w], ref[w], name, where,
                                         dA_scale if w == "dA" else None)
                        for w in got}
                errs[name] = by_case[shape, name] = line
                print(f"[kernel] ssd backward {name} (Bt,S,H,P,G,N,chunk,model A)="
                      f"{shape} h0={with_h0} dh_final={with_dhf}: min cum "
                      f"{cum.min().item():.1f}, max|err| "
                      + ", ".join(f"{w} {e:.3e}" for w, e in line.items())
                      + f", launches {launched} (tol {SSD_BWD_TOL[name]:g}; "
                      f"{', '.join(SSD_BWD_SCALED)} "
                      "relative to the largest |ref|, dA to the sum of its "
                      f"terms' magnitudes, {dA_scale.max().item():.4e})")
                del got, ref
    # the last case of each shape and type: no h0 or dh_final
    grads = ("dx", "ddt", "dA", "dB", "dC", "dD")

    def per_kernel(bf):
        return {"ssd_bwd_dstate": bf["dS"],
                "ssd_bwd_state_pass": max(bf["dchunk_in"], bf["dh0"], bf["end"]),
                SSD_BWD_TC: max(bf[w] for w in grads)}
    train = SSD_BWD_GRID[-1]
    return {**per_kernel(by_case[train, "bfloat16"]),
            "ssd_bwd_chunk_f32": max(by_case[train, "float32"][w] for w in grads),
            "physical mode": per_kernel(by_case[CLUSTER_SSD, "bfloat16"])}


def functions_vs_autograd(device) -> None:
    """``SSDScan`` through ``ops.ssd`` (also at a ragged length, through the
    padding) and ``RGLRUScan`` through ``ops.rglru_scan`` with grad on:
    their launches, and every input's gradient against autograd through
    the plain versions from the same inputs, f32 and bf16, at the
    tolerances of the kernels against their plain versions (the SSD's
    scaled as SSD_BWD_TOL; the scan's 1e-5, bf16 one step)."""
    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.kernels.rglru_scan.ops import rglru_scan
    from repro_torch.kernels.ssd_scan.kernel import bwd_kernels
    from repro_torch.kernels.ssd_scan.ops import ssd
    names = ("dx", "ddt", "dA", "dB", "dC", "dD", "dh0")
    # the glue around the kernels, which phase 2 checks at every shape: the
    # padding, G 2 and 3, a chunk that is not a multiple of 16
    for shape in ((1, 80, 4, 16, 2, 16, 32, True), (1, 96, 6, 32, 3, 16, 24, True)):
        for name in ("float32", "bfloat16"):
            x, dt, A, B, C, D = ssd_inputs(shape, getattr(torch, name), device,
                                           seed=900)
            Bt, S, H, P, G, N, chunk = shape[:7]
            g = torch.Generator(device).manual_seed(901)
            h0 = torch.randn(Bt, H, P, N, generator=g, device=device)
            dy = torch.randn(x.shape, generator=g, device=device).to(x.dtype)
            dhf = torch.randn(h0.shape, generator=g, device=device)
            grads = {}
            for impl in ("auto", "reference"):
                leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C, D, h0)]
                LAUNCHES.clear()
                y, h = ssd(*leaves[:6], chunk=chunk, h0=leaves[6], impl=impl)
                grads[impl] = torch.autograd.grad([y, h], leaves, [dy, dhf])
                torch.cuda.synchronize(device)
                if impl == "auto":
                    launches = dict(LAUNCHES)
            fwd = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan") \
                if name == "bfloat16" else ("ssd_chunk",)
            check(launches == dict.fromkeys(fwd + bwd_kernels(x.dtype), 1),
                  f"ops.ssd with grad launched {launches}")
            line = {w: ssd_bwd_check(w, a, b, name, f"ops.ssd {shape} {name}")
                    for w, a, b in zip(names, *grads.values())}
            print(f"[kernel] SSDScan {name} through ops.ssd, S={S} chunk={chunk}"
                  f" (padded: {S % chunk != 0}), vs autograd through "
                  f"ssd_chunked_ref: launches {launches}; max|err| "
                  + ", ".join(f"{w} {e:.3e}" for w, e in line.items()))
    for shape in (RGLRU_GRID[3], RGLRU_SERVE):
        for name in ("float32", "bfloat16"):
            a, u, _ = rglru_inputs(shape, getattr(torch, name), device, seed=902)
            B, S, R = a.shape
            g = torch.Generator(device).manual_seed(903)
            h0 = torch.randn(B, R, generator=g, device=device)
            dh = torch.randn(a.shape, generator=g, device=device).to(a.dtype)
            dhf = torch.randn(B, R, generator=g, device=device)
            grads = {}
            for impl in ("auto", "sequential"):
                leaves = [t.clone().requires_grad_() for t in (a, u, h0)]
                LAUNCHES.clear()
                hs, hf = rglru_scan(*leaves, impl=impl)
                grads[impl] = torch.autograd.grad([hs, hf], leaves, [dh, dhf])
                torch.cuda.synchronize(device)
                if impl == "auto":
                    launches = dict(LAUNCHES)
            check(launches == {"rglru_scan": 1, "rglru_scan_bwd": 1},
                  f"ops.rglru_scan with grad launched {launches}")
            errs = []
            for what, got, ref in zip(("da", "du", "dh0"), *grads.values()):
                tol = TOL[name] if name == "bfloat16" and what != "dh0" \
                    else RGLRU_TOL
                e, excess = excess_error(got, ref, tol)
                check(got.dtype == ref.dtype and excess <= 0,
                      f"RGLRUScan {what} disagrees with autograd at {shape} "
                      f"{name}: max|err| {e:.3e}")
                errs.append(e)
            print(f"[kernel] RGLRUScan {name} through ops.rglru_scan "
                  f"(B,S,R)={(B, S, R)} vs autograd through rglru_scan_ref: "
                  f"launches {launches}; max|err| da {errs[0]:.3e}, du "
                  f"{errs[1]:.3e}, dh0 {errs[2]:.3e}")


def attention_bwd_bounds(shape) -> dict:
    """Least ms of each backward kernel and of the whole backward at a bf16
    ``shape``: each input read once, each output written once; the
    products each needs (one product: 2 hd flops a visible pair), at the
    bf16 tensor-core rate: dK and dV need S, dP, dV and dK (4), dQ needs S,
    dP and dQ (3), the whole gradient 5."""
    B, S, H, KH, hd, window, causal = shape
    prod = 2 * hd * B * H * visible_pairs(shape)
    qb, kvb, rowb = 2 * B * S * H * hd, 2 * B * S * KH * hd, 4 * B * H * S
    return {
        "flash_attn_bwd_pre": bound(2 * qb + rowb, 2 * B * S * H * hd),
        "flash_attn_bwd_dkdv": bound(2 * qb + 4 * kvb + 2 * rowb, 4 * prod),
        "flash_attn_bwd_dq": bound(3 * qb + 2 * kvb + 2 * rowb, 3 * prod),
        # q, k, v, o, dO and L read, dq, dk and dv written
        "whole": bound(4 * qb + 4 * kvb + rowb, 5 * prod),
    }


def bwd_timing(device, shape=TRAIN_SHAPE) -> dict:
    """Phase 3 for the flash backward at a training shape (bf16, causal; a
    window that does not bite at S, so SDPA's causal mask computes the same
    function):
    each kernel with its bound, registers and shared memory (dK/dV with the
    parts ``bwd_splits`` picks, its time including the sum of the parts);
    plain_ms of flash_attn_bwd_pre is rowsum(dO o O) in PyTorch, of the
    other two ``attention_bwd_ref``, which computes dq, dk and dv together;
    no single PyTorch call computes one kernel's part (library_ms null).  Then the
    whole backward (``flash_attention_bwd``) beside the sum of its kernels,
    ``attention_bwd_ref`` and SDPA's backward alone (its forward run once,
    K/V by ``enable_gqa``), the yardstick the port never calls; and the
    forward with and without its log-sum-exp."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.kernel import (
        BWD_KERNELS, bwd_attributes, bwd_buffers, flash_attention_bwd,
        flash_attention_fwd, launch_bwd)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    B, S, H, KH, hd, window, causal = shape
    check(causal and (window is None or window >= S), "SDPA's mask differs")
    q, k, v = qkv(shape, torch.bfloat16, device, seed=97)
    do = torch.randn(q.shape, generator=torch.Generator(device).manual_seed(96),
                     device=device).to(torch.bfloat16)
    o, lse = flash_attention_fwd(q, k, v, causal=True, window=window,
                                 return_lse=True)
    bufs = bwd_buffers(q, k, v, o, lse, do, window=window)
    bounds = attention_bwd_bounds(shape)
    plain_ms = time_ms(lambda: attention_bwd_ref(q, k, v, o, lse, do,
                                                 window=window), 3, warmup=1)
    out = {}
    for name in BWD_KERNELS:
        out[name] = {
            "ms": time_ms(lambda: launch_bwd(name, bufs, causal=True,
                                             window=window), 20),
            "plain_ms": time_ms(lambda: (do.float() * o.float()).sum(-1), 20)
            if name == "flash_attn_bwd_pre" else plain_ms,
            "library_ms": None}
        out[name]["bound_ms"], out[name]["bound_by"] = bounds[name]
        out[name].update(bwd_attributes(name, hd, torch.bfloat16))
        if name == "flash_attn_bwd_dkdv":
            out[name]["splits"] = bufs["splits"]
        print(f"[timing] {name} at B={B} S={S} H={H} KH={KH} hd={hd} bf16 "
              "causal: " + ", ".join(f"{k} {v}" for k, v in out[name].items()))
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                        enable_gqa=True)
    dot = do.transpose(1, 2)
    whole = {
        "ms": time_ms(lambda: flash_attention_bwd(q, k, v, o, lse, do,
                                                  window=window), 20),
        "sum_ms": sum(out[name]["ms"] for name in BWD_KERNELS),
        "plain_ms": plain_ms,
        "library_ms": time_ms(lambda: torch.autograd.grad(
            ot, (qt, kt, vt), dot, retain_graph=True), 20),
        "fwd_ms": time_ms(lambda: flash_attention_fwd(q, k, v, causal=True,
                                                      window=window), 20),
        "fwd_with_lse_ms": time_ms(lambda: flash_attention_fwd(
            q, k, v, causal=True, window=window, return_lse=True), 20),
    }
    whole["bound_ms"], whole["bound_by"] = bounds["whole"]
    print(f"[timing] whole flash backward at B={B} S={S} H={H} KH={KH} hd={hd} "
          "(ms; sum_ms: its "
          "three kernels timed apart; plain_ms: attention_bwd_ref; library_ms: "
          "SDPA's backward alone; fwd_ms and fwd_with_lse_ms: flash_attn_fwd "
          "without and with its log-sum-exp): "
          + ", ".join(f"{k} {v}" for k, v in whole.items()))
    for name in ("flash_attn_bwd_dkdv", "flash_attn_bwd_dq"):
        out[name]["whole_backward"] = whole
    return out


def rglru_bwd_timing(device) -> dict:
    """Phase 3 for rglru_scan_bwd at recurrentgemma-2b's training shape (f32,
    as the model's gates give a and u).  No single PyTorch call computes the
    gradient of a linear recurrence: library_ms is null.  The bound counts
    a, the f32 states and dh_seq read once, da and du written once (and h0,
    dh_final, dh0); 3 flops an element."""
    import torch
    from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_bwd,
                                                       rglru_scan_fwd)
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref
    a, u, _ = rglru_inputs(RGLRU_SERVE, torch.float32, device, seed=97)
    B, S, R = a.shape
    g = torch.Generator(device).manual_seed(96)
    dh = torch.randn(B, S, R, generator=g, device=device)
    dhf = torch.randn(B, R, generator=g, device=device)
    _, _, h_state = rglru_scan_fwd(a, u, return_state=True)
    h_prev = torch.cat([torch.zeros_like(h_state[:, :1]), h_state[:, :-1]], 1)
    out = {
        "ms": time_ms(lambda: rglru_scan_bwd(a, h_state, None, dh, dhf), 50),
        "plain_ms": time_ms(lambda: rglru_scan_bwd_ref(a, h_prev, dh, dhf), 3,
                            warmup=1),
        "library_ms": None,
        "fwd_ms": time_ms(lambda: rglru_scan_fwd(a, u), 50),
    }
    out["bound_ms"], out["bound_by"] = bound(4 * (5 * B * S * R + 2 * B * R),
                                             3 * B * S * R, PEAK_F32_FLOPS)
    print(f"[timing] rglru_scan_bwd at B={B} S={S} R={R} f32 (no single PyTorch "
          "call computes it: library_ms null; fwd_ms: rglru_scan in the same "
          "run): " + ", ".join(f"{k} {v}" for k, v in out.items()))
    return out


def ssd_bwd_bounds(shape, in_bytes: int = 2,
                   peak_flops: float = PEAK_BF16_FLOPS) -> dict:
    """Least ms of each SSD backward kernel and of the whole SSD backward at
    ``shape`` (x, dy, B, C, dx of ``in_bytes``: 2 bf16, 4 f32; the rest f32):
    each input read once, each output written once; the products each
    needs, once (per (batch, head, chunk) the causal dy.x^T and T^T.dy,
    Q(Q+1)/2 P products each, and B.dchunk_in^T, x.dchunk_in and dy.h_in,
    Q P N each; per (batch, group, chunk) C.B^T, dCB.B and dCB^T.C,
    Q(Q+1)/2 N each), at ``peak_flops`` (the rate of their inputs' type;
    ssd_bwd_state_pass's f32 sums at the f32 rate)."""
    Bt, S, H, P, G, N, Q = shape
    nc = S // Q
    x = in_bytes * Bt * S * H * P
    bc, f32 = in_bytes * Bt * S * G * N, 4 * Bt * S * H
    states, per_chunk = 4 * Bt * nc * H * P * N, 4 * Bt * nc * H
    causal = Q * (Q + 1) // 2
    dstate_flops = 2 * Bt * nc * H * Q * P * N
    chunk_flops = (2 * Bt * nc * H * (2 * causal * P + 3 * Q * P * N)
                   + 2 * Bt * nc * G * 3 * causal * N)
    f32_bc = 4 * Bt * S * G * N
    return {
        # dy, cum, C read; dS written
        "ssd_bwd_dstate": bound(x + f32 + bc + states, dstate_flops, peak_flops),
        # dS, h_ins and cum (the chunk ends) read (this run has no
        # dh_final); dchunk_in, dh0 and the chunk-end term written
        "ssd_bwd_state_pass": bound(
            3 * states + per_chunk + states // nc + per_chunk,
            4 * Bt * nc * H * P * N, PEAK_F32_FLOPS),
        # x, dt, cum, B, C, dy, h_ins, dchunk_in, the chunk-end term read; dx,
        # ddt, dB and dC (f32) written
        "ssd_bwd_chunk": bound(2 * x + 2 * f32 + 2 * bc + 2 * states + per_chunk
                               + x + f32 + 2 * f32_bc, chunk_flops, peak_flops),
        # x, dt, cum, B, C, dy, h_ins read; dx, ddt, dB, dC, dh0 written
        "whole": bound(2 * x + 2 * f32 + 2 * bc + states
                       + x + f32 + 2 * f32_bc + states // nc,
                       dstate_flops + chunk_flops, peak_flops),
    }


def ssd_bwd_timing(device) -> dict:
    """Phase 3 for the SSD backward at mamba2-780m's training shape (bf16 x,
    B, C, dy; the model's A): each kernel of the bf16 path (ssd_bwd_dstate,
    ssd_bwd_state_pass, the tensor-core ssd_bwd_chunk_tc) beside its plain
    version and its bound, with its registers and shared bytes; ssd_bwd.cu's
    CUDA-core ssd_bwd_chunk on the same bf16 inputs (the design the
    tensor-core kernel replaced there: ``ssd_bwd_chunk_cuda_cores``, checked
    as phase 2 checks the bf16 kernels), and beside it that kernel on f32
    inputs (its live path, the f32-compute gate's) with its f32 bound under
    ``f32_``; then the whole bf16 backward (the three wrappers, with the
    partial sums in PyTorch) beside autograd through ``ssd_chunked_ref`` from
    the same inputs.  One PyTorch call, ``torch.einsum``, computes
    ssd_bwd_dstate's product from dy exp(cum); none computes the others:
    library_ms null."""
    import torch
    from repro_torch.kernels.ssd_scan.kernel import (BWD_TC_HEAD_BLOCK,
                                                     bwd_attributes,
                                                     ssd_bwd_chunk,
                                                     ssd_bwd_chunk_cuda_cores,
                                                     ssd_bwd_dstate,
                                                     ssd_bwd_state_pass)
    from repro_torch.kernels.ssd_scan.ref import (chunk_bwd_ref,
                                                  chunk_dstate_ref,
                                                  ssd_chunked_ref,
                                                  state_pass_bwd_ref)
    x, dt, A, B, C, D, cum, h_ins, dy, dhf = ssd_bwd_case(
        SSD_SERVE + (True,), torch.bfloat16, device, 95, False, False)
    chunk = SSD_SERVE[6]
    dS = ssd_bwd_dstate(dy, cum, C, chunk=chunk)
    dchunk_in, _, end = ssd_bwd_state_pass(dS, cum, h_ins, chunk=chunk)
    chunk_args = (x, dt, A, cum, B, C, D, dy, h_ins, dchunk_in, end)
    runs = {
        "ssd_bwd_dstate": (lambda: ssd_bwd_dstate(dy, cum, C, chunk=chunk),
                           lambda: chunk_dstate_ref(dy, cum, C, chunk=chunk)),
        "ssd_bwd_state_pass": (
            lambda: ssd_bwd_state_pass(dS, cum, h_ins, chunk=chunk),
            lambda: state_pass_bwd_ref(dS, cum, h_ins, chunk=chunk)),
        SSD_BWD_TC: (lambda: ssd_bwd_chunk(*chunk_args, chunk=chunk),
                     lambda: chunk_bwd_ref(*chunk_args, chunk=chunk)),
        "ssd_bwd_chunk": (
            lambda: ssd_bwd_chunk_cuda_cores(*chunk_args, chunk=chunk),
            lambda: chunk_bwd_ref(*chunk_args, chunk=chunk)),
    }
    # dS's product alone, in one PyTorch call: torch.einsum of dy exp(cum)
    # (prescaled here, outside the timing) and C, as chunk_dstate_ref forms it
    Bt, S, H, P, G, N, _ = SSD_SERVE
    nc = S // chunk
    dyw = (dy.float() * torch.exp(cum)[..., None]).reshape(Bt, nc, chunk, G,
                                                           H // G, P)
    cf = C.float().reshape(Bt, nc, chunk, G, N)
    library = {"ssd_bwd_dstate": lambda: torch.einsum("bcqgrp,bcqgn->bcgrpn",
                                                      dyw, cf)}
    bounds = ssd_bwd_bounds(SSD_SERVE)
    bounds[SSD_BWD_TC] = bounds["ssd_bwd_chunk"]
    out = {}
    for name, (fast, plain) in runs.items():
        out[name] = {"ms": time_ms(fast, 10), "plain_ms": time_ms(plain, 2, warmup=1),
                     "library_ms": time_ms(library[name], 10)
                     if name in library else None}
        out[name]["bound_ms"], out[name]["bound_by"] = bounds[name]
        out[name].update(bwd_attributes(name, P, N, torch.bfloat16))
    out[SSD_BWD_TC]["head_block"] = BWD_TC_HEAD_BLOCK
    # the replaced kernel's gradients on these inputs, gated as phase 2's
    *ref, dA_scale = chunk_bwd_ref(*chunk_args, chunk=chunk, dA_scale=True)
    got = ssd_bwd_chunk_cuda_cores(*chunk_args, chunk=chunk)
    out["ssd_bwd_chunk"]["max_abs_err"] = max(
        ssd_bwd_check(w, g, r, "bfloat16", "ssd_bwd_chunk_cuda_cores at the "
                      "training shape", dA_scale if w == "dA" else None)
        for w, g, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, ref))
    del got, ref
    # ... and on f32 inputs, its live path
    f32_args = tuple(t.float() if t.dtype == torch.bfloat16 else t
                     for t in chunk_args)
    f32 = out["ssd_bwd_chunk"]
    f32["f32_ms"] = time_ms(lambda: ssd_bwd_chunk(*f32_args, chunk=chunk), 10)
    f32["f32_plain_ms"] = time_ms(lambda: chunk_bwd_ref(*f32_args, chunk=chunk),
                                  2, warmup=1)
    f32["f32_bound_ms"], f32["f32_bound_by"] = ssd_bwd_bounds(
        SSD_SERVE, 4, PEAK_F32_FLOPS)["ssd_bwd_chunk"]
    f32.update({f"f32_{k}": v for k, v in
                bwd_attributes("ssd_bwd_chunk", P, N, torch.float32).items()})
    del dyw, cf, f32_args
    for name in runs:
        print(f"[timing] {name} at Bt=4 S=2048 H=48 P=64 G=1 N=128 chunk=256 "
              "bf16 (library_ms: ssd_bwd_dstate's product by torch.einsum on "
              "the prescaled f32 dy exp(cum) and C; no single PyTorch call "
              "computes the others, null; ssd_bwd_chunk: ssd_bwd.cu's "
              "CUDA-core kernel, which the bf16 path no longer runs, and f32_: "
              "the same kernel on f32 inputs): "
              + ", ".join(f"{k} {v}" for k, v in out[name].items()))

    def kernels():
        s = ssd_bwd_dstate(dy, cum, C, chunk=chunk)
        dci, _, e = ssd_bwd_state_pass(s, cum, h_ins, chunk=chunk)
        return ssd_bwd_chunk(x, dt, A, cum, B, C, D, dy, h_ins, dci, e,
                             chunk=chunk)

    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B, C, D)]
    y_ref, _ = ssd_chunked_ref(*leaves, chunk=chunk)
    whole = {"ms": time_ms(kernels, 10),
             "plain_ms": time_ms(lambda: torch.autograd.grad(
                 y_ref, leaves, dy, retain_graph=True), 2, warmup=1)}
    whole["bound_ms"], whole["bound_by"] = bounds["whole"]
    del y_ref, leaves
    print("[timing] whole SSD backward at the same shape, bf16 (ms; the three "
          "kernels and the partial sums; plain_ms: autograd through "
          "ssd_chunked_ref): " + ", ".join(f"{k} {v}" for k, v in whole.items()))
    out["ssd_bwd_chunk"]["whole_backward"] = whole
    torch.cuda.empty_cache()
    return out


def train_and_check(device, arch: str) -> dict:
    """Phase 4 for training: ``repro_torch.launch.train`` on full-width
    ``arch`` (batch and steps from TRAIN_CELLS, random weights), its
    launches per step (``TRAIN_PATHS[arch]``, nothing else) and finite
    losses; after qwen3-0.6b's run a checkpoint at step 2 and a resume that
    starts there.  Returns the run's numbers and launch counts."""
    import math
    import tempfile
    import torch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.launch import train

    batch, steps = TRAIN_CELLS[arch]
    want = TRAIN_PATHS[arch]
    LAUNCHES.clear()
    stats = train.main(train_argv(arch, steps))
    launches = dict(LAUNCHES)
    del stats["state"]
    check(stats["arch"] == arch, "train did not run the full-width config")
    for i, per_step in enumerate(stats["launches"]):
        check(per_step == want, f"{arch} training step {i + 1} launched "
              f"{per_step}, expected {want}")
    check(launches == {k: n * steps for k, n in want.items()},
          f"{arch} training launched {launches}")
    check(len(stats["losses"]) == steps
          and all(math.isfinite(x) for x in stats["losses"]),
          f"{arch} training losses {stats['losses']}")
    stats["tokens_per_s"] = [stats["tokens_per_step"] / (ms / 1e3)
                             for ms in stats["step_ms"]]
    print("[train] " + json.dumps(stats))
    print(f"[train] {arch} batch {batch} x {PROMPT}: launches per step "
          f"{stats['launches'][0]}; losses {stats['losses']}; step ms "
          f"{stats['step_ms']}, tokens/s {stats['tokens_per_s']}, peak memory "
          f"{stats['max_memory_allocated']} bytes")
    if arch == "qwen3-0.6b":
        with tempfile.TemporaryDirectory() as ckpt:
            first = train.main(train_argv(arch, 2, "--checkpoint-dir", ckpt,
                                          "--checkpoint-every", "1000"))
            del first["state"]
            resumed = train.main(train_argv(arch, 3, "--checkpoint-dir", ckpt))
            del resumed["state"]
        check(resumed["start_step"] == 2 and len(resumed["losses"]) == 1
              and math.isfinite(resumed["losses"][0]),
              f"the resumed run started at {resumed['start_step']} with losses "
              f"{resumed['losses']}")
        print(f"[train] checkpoint at step 2 and resume: the resumed run starts "
              f"at step {resumed['start_step']}; its loss "
              f"{resumed['losses'][0]:.6f}, the uninterrupted run's at that step "
              f"{stats['losses'][2]:.6f}")
    torch.cuda.empty_cache()
    return {"launches": launches, "stats": stats}



def cluster_launches(arch: str) -> dict:
    """A physical-mode job's launches a training step: a dense model's
    flash forward twice a layer (the step's forward and the recompute) and
    each flash backward kernel once a layer; mamba2-780m's TRAIN_PATHS
    (which calibration checks at 2 x 32)."""
    if arch == "mamba2-780m":
        return dict(TRAIN_PATHS[arch])
    from repro_torch.configs import ARCHS
    n = ARCHS[arch].n_layers
    return {"flash_attn_fwd": 2 * n, **dict.fromkeys(BWD_KERNEL_NAMES, n)}


def cluster_and_check(device) -> dict:
    """Phase 4's physical mode: ``repro_torch.cluster.localcloud.LocalCloud``
    runs rounds of ``EvaScheduler`` over CLUSTER_JOBS on the card, full
    width, each worker on its own CUDA stream.  First each job's solo run
    (``_Worker`` in a throwaway directory, CALIBRATION_STEPS steps) gives its
    standalone steps/s and checks its launches a step; then, with the counts
    set to 0, ``LocalCloud.run``.  Fails unless every job finishes its
    steps, the bill is positive, no worker raised, and each kernel launched
    exactly the jobs' steps times their launches a step, no other kernel.
    Returns the run's numbers and launch counts."""
    import shutil
    import tempfile
    import torch
    from repro_torch.cluster.localcloud import LocalCloud, LocalJob, _Worker
    from repro_torch.configs import ARCHS
    from repro_torch.core import Catalog, EvaScheduler
    from repro_torch.core.catalog import InstanceType
    from repro_torch.kernels import LAUNCHES

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="physical-mode-",
                               dir=os.path.join(ROOT, "build"))
    try:
        jobs, solo = [], {}
        for job_id, workload, arch, steps, demand in CLUSTER_JOBS:
            per_step = cluster_launches(arch)
            job = LocalJob(job_id, workload, ARCHS[arch], CALIBRATION_STEPS,
                           demand)
            worker = _Worker(job, os.path.join(workdir, f"solo-{job_id}"))
            LAUNCHES.clear()
            t = time.perf_counter()
            worker.start()
            worker.join()
            wall = time.perf_counter() - t
            if worker.error is not None:
                print(f"[cluster] {arch}'s solo worker raised: "
                      f"{worker.error!r}")
            check(worker.error is None and job.done,
                  f"{arch}'s solo worker did not finish: {worker.error!r}")
            check(dict(LAUNCHES) == {k: n * CALIBRATION_STEPS
                                     for k, n in per_step.items()},
                  f"{arch}'s solo run at 2 x 32 launched {dict(LAUNCHES)}, "
                  f"expected {per_step} a step")
            stamps = worker.window[CALIBRATION_WARMUP:]
            sps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
            solo[arch] = {"standalone_sps": sps, "wall_s": wall,
                          "launches_per_step": per_step}
            print(f"[cluster] {arch} solo: {sps:.3f} steps/s over steps "
                  f"{CALIBRATION_WARMUP + 1}-{CALIBRATION_STEPS} at 2 x 32, "
                  f"launches a step {per_step}; the run with its init and "
                  f"checkpoint {wall:.1f} s")
            shutil.rmtree(os.path.join(workdir, f"solo-{job_id}"))
            jobs.append(LocalJob(job_id, workload, ARCHS[arch], steps, demand,
                                 standalone_sps=sps))
            torch.cuda.empty_cache()

        catalog = Catalog.from_types([InstanceType(*t) for t in CLUSTER_TYPES])
        sched = EvaScheduler(catalog)
        cloud = LocalCloud(catalog, sched, jobs, round_s=CLUSTER_ROUND_S,
                           workdir=os.path.join(workdir, "cloud"))
        arch_of = {j.job_id: j.arch_cfg.name for j in jobs}
        rounds, reports = [], []
        step_round, observe = cloud.step_round, sched.observe_single

        def traced_round(now):  # what each round saw, then the round itself
            rounds.append({
                "t_s": now - t0,
                "steps_per_s": {arch_of[t]: w.throughput()
                                for t, w in cloud.workers.items()},
                "instances": [(catalog.types[i["type"]].name,
                               sorted(arch_of[t] for t in i["tasks"]))
                              for i in cloud.instances.values()]})
            step_round(now)

        def traced_observe(workload, colocated, value):
            reports.append((workload, list(colocated), value))
            observe(workload, colocated, value)

        cloud.step_round, sched.observe_single = traced_round, traced_observe
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        LAUNCHES.clear()
        t0 = time.time()
        try:
            out = cloud.run(timeout_s=CLUSTER_TIMEOUT_S)
        except Exception as e:  # run() has stopped the other workers
            print(f"[cluster] a worker raised: {e!r}")
            raise
        wall = time.time() - t0
        torch.cuda.synchronize(device)
        launches = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated(device)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    want = collections.Counter()
    for j in jobs:
        for k, n in cluster_launches(j.arch_cfg.name).items():
            want[k] += n * j.total_steps
    print(f"[cluster] rounds {sched.rounds}, migrations {out['migrations']}, "
          f"bill ${out['cost']:.6f} ({CLUSTER_ROUND_S} s rounds, billed by "
          f"uptime at the local catalog's $/h), wall {wall:.1f} s, steps "
          f"{ {arch_of[t]: n for t, n in out['steps'].items()} }, all_done "
          f"{out['all_done']}, peak memory {peak} bytes")
    for r in rounds:
        print(f"[cluster] round at {r['t_s']:.1f} s: steps/s "
              + json.dumps({a: round(v, 4) for a, v in r["steps_per_s"].items()})
              + f", instances {r['instances']}")
    colocated = {}
    for j in jobs:
        seen = [r["steps_per_s"][j.arch_cfg.name] for r in rounds
                if r["steps_per_s"].get(j.arch_cfg.name, 0) > 0]
        colocated[j.arch_cfg.name] = seen
        print(f"[cluster] {j.arch_cfg.name}: solo {j.standalone_sps:.3f} "
              f"steps/s; under the scheduler {seen} steps/s (a round's 10 s "
              f"window)")
    print(f"[cluster] interference reports to the scheduler (workload, "
          f"co-located workloads, steps/s over solo, capped at 1): {reports}")
    print(f"[cluster] launches {launches}, expected {dict(want)}")
    check(out["all_done"] and all(out["steps"][j.job_id] >= j.total_steps
                                  for j in jobs),
          f"the physical mode did not finish its jobs: {out}")
    check(out["cost"] > 0, f"the physical mode billed {out['cost']}")
    check(launches == dict(want), f"the physical mode launched {launches}, "
          f"expected {dict(want)}")
    return {"launches": launches, "solo": solo, "colocated_sps": colocated,
            "rounds": sched.rounds, "migrations": out["migrations"],
            "cost": out["cost"], "wall_s": wall, "peak_bytes": peak}

def train_grads(cfg, params, batch, impl: str):
    """One training step's loss and gradient leaves, by flat key."""
    import torch
    from repro_torch.models.lm import forward
    from repro_torch.models.params import flatten
    from repro_torch.models.steps import chunked_ce_loss
    flat = flatten(params)
    h, _ = forward(params, cfg, batch["tokens"], mode="train", impl=impl)
    loss = chunked_ce_loss(params, h, batch["labels"], cfg)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.item(), dict(zip(flat, grads))


def worst_leaf(got: dict, ref: dict) -> tuple:
    """max over leaves of max|got - ref| / max|ref|, and that leaf."""
    ratios = {k: ((got[k] - ref[k]).abs().max()
                  / ref[k].abs().max().clamp_min(1e-30)).item() for k in ref}
    key = max(ratios, key=ratios.get)
    return ratios[key], key


@contextlib.contextmanager
def ulp_noise(cfg):
    """The plain path with one f32 ulp of relative noise in the output of its
    SSD intra term (mamba2-780m), its RG-LRU scan (recurrentgemma-2b) or its
    attention (the dense models): the spread of the plain path against
    itself, a floor for kernel vs plain.  The noise is a function of the
    output, so a rematerialised recompute sees what the forward saw."""
    import torch
    if cfg.ssm:
        from repro_torch.kernels.ssd_scan import ref as module
        name = "ssd_chunk_ref"
    elif "rglru" in cfg.layer_kinds:
        from repro_torch.kernels.rglru_scan import ops as module
        name = "rglru_scan_assoc"
    else:
        from repro_torch.models import layers as module
        name = "flash_attention"
    plain = getattr(module, name)

    def noisy(*args, **kwargs):
        out = plain(*args, **kwargs)
        y, rest = (out[0], out[1:]) if isinstance(out, tuple) else (out, None)
        y = y * (1 + 2 ** -23 * torch.sin(1e4 * y.detach()))
        return y if rest is None else (y, *rest)

    setattr(module, name, noisy)
    try:
        yield
    finally:
        setattr(module, name, plain)


def attention_both(plain, worst: dict, seen: list):
    """A stand-in for ``layers.flash_attention`` whose forward is the plain
    attention and whose backward also runs the forward kernel and the
    backward kernels on the layer's q, k, v and dO and compares their
    gradients with autograd through the plain attention, at the bf16 kernel
    tolerance.  The backward is linear in dO, so both take dO scaled to a
    largest |dO| of 1, where an absolute tolerance means something."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd,
                                                            flash_attention_fwd)

    class Both(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, causal, window):
            ctx.save_for_backward(q, k, v)
            ctx.causal, ctx.window = causal, window
            return plain(q, k, v, causal=causal, window=window, impl="reference")

        @staticmethod
        def backward(ctx, do):
            q, k, v = ctx.saved_tensors
            mask = dict(causal=ctx.causal, window=ctx.window)
            unit = (do.float() / do.float().abs().max().clamp_min(1e-30)).to(do.dtype)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                o = plain(*leaves, impl="reference", **mask)
                ref = torch.autograd.grad(o, leaves, unit, retain_graph=True)
                grads = torch.autograd.grad(o, leaves, do)
            o_k, lse = flash_attention_fwd(q, k, v, return_lse=True, **mask)
            got = flash_attention_bwd(q, k, v, o_k, lse, unit.contiguous(), **mask)
            for what, g, r in zip(("dq", "dk", "dv"), got, ref):
                err, excess = excess_error(g, r, BWD_TOL["bfloat16"])
                check(g.dtype == r.dtype and bool(torch.isfinite(g).all())
                      and excess <= 0, f"layer {len(seen)}: attention {what} "
                      f"of the kernels disagrees with plain (max|err| {err:.3e})")
                worst[what] = max(worst[what], err)
            seen.append(q.dtype)
            return (*grads, None, None)

    def both(q, k, v, *, causal, window, impl):
        return Both.apply(q, k, v, causal, window)

    return both


def ssd_both(plain, worst: dict, seen: list):
    """A stand-in for ``ssm.ssd`` whose forward is the plain SSD and whose
    backward also runs ``SSDScan`` (the forward and backward kernels) on the
    layer's inputs and compares its gradients with autograd through the
    plain SSD, dy scaled to a largest |dy| of 1, at the SSD backward's bf16
    tolerance (``ssd_bwd_check``)."""
    import torch
    from repro_torch.kernels.ssd_scan.ops import SSDScan

    class Both(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, dt, A, B, C, D, chunk):
            ctx.save_for_backward(x, dt, A, B, C, D)
            ctx.chunk = chunk
            ctx.set_materialize_grads(False)
            return plain(x, dt, A, B, C, D, chunk=chunk, impl="reference")

        @staticmethod
        def backward(ctx, dy, dh):
            check(dh is None, "the final state of a training step has a gradient")
            unit = (dy.float() / dy.float().abs().max().clamp_min(1e-30)).to(dy.dtype)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
                y, _ = plain(*leaves, chunk=ctx.chunk, impl="reference")
                ref = torch.autograd.grad(y, leaves, unit, retain_graph=True)
                grads = torch.autograd.grad(y, leaves, dy)
                y_k, _ = SSDScan.apply(*leaves, None, ctx.chunk)
                got = torch.autograd.grad(y_k, leaves, unit)
            for what, g, r in zip(("dx", "ddt", "dA", "dB", "dC", "dD"), got, ref):
                check(g.dtype == r.dtype, f"SSD {what} dtype {g.dtype}")
                worst[what] = max(worst.get(what, 0.0), ssd_bwd_check(
                    what, g, r, "bfloat16", f"layer {len(seen)}"))
            seen.append(leaves[0].dtype)
            return (*grads, None)

    def both(x, dt, A, B, C, D, *, chunk, impl):
        return Both.apply(x, dt, A, B, C, D, chunk)

    return both


def scan_both(plain, worst: dict, seen: list):
    """A stand-in for ``rglru.rglru_scan`` whose forward is the plain scan
    and whose backward also runs ``RGLRUScan`` (the scan kernel and its
    backward) on the layer's a and u and compares their gradients with
    autograd through the plain scan, dh_seq scaled to a largest |dh| of 1,
    within 2e-2 abs + rel."""
    import torch
    from repro_torch.kernels.rglru_scan.ops import RGLRUScan

    class Both(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a, u):
            ctx.save_for_backward(a, u)
            ctx.set_materialize_grads(False)
            hs, h_final = plain(a, u, None, impl="reference")
            return hs, h_final.clone()  # not a view of hs

        @staticmethod
        def backward(ctx, dhs, dhf):
            check(dhf is None, "the final state of a training step has a gradient")
            unit = dhs / dhs.abs().max().clamp_min(1e-30)
            with torch.enable_grad():
                leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
                hs, _ = plain(*leaves, None, impl="reference")
                ref = torch.autograd.grad(hs, leaves, unit, retain_graph=True)
                grads = torch.autograd.grad(hs, leaves, dhs)
                hs_k, _ = RGLRUScan.apply(*leaves, None)
                got = torch.autograd.grad(hs_k, leaves, unit)
            for what, g, r in zip(("da", "du"), got, ref):
                err, excess = excess_error(g, r, BWD_TOL["bfloat16"])
                check(g.dtype == r.dtype and bool(torch.isfinite(g).all())
                      and excess <= 0, f"layer {len(seen)}: RG-LRU {what} of the "
                      f"kernels disagrees with plain (max|err| {err:.3e})")
                worst[what] = max(worst.get(what, 0.0), err)
            seen.append(leaves[0].dtype)
            return grads

    def both(a, u, h0=None, *, impl):
        check(h0 is None, "a training step's scan starts from zeros")
        return Both.apply(a, u)

    return both


def layer_grad_parity(cfg, params, batch) -> dict:
    """Every layer's attention, SSD and RG-LRU backward in bf16 compute,
    kernels against autograd through the plain versions, on the plain path's
    activations of one training step (``attention_both``, ``ssd_both``,
    ``scan_both``), each layer of its kind once (``TRAIN_PATHS``).  Returns
    the number of layers compared, by kind."""
    import torch
    from repro_torch.models import layers, rglru, ssm
    worst, seen = {"dq": 0.0, "dk": 0.0, "dv": 0.0}, {"ssd": [], "rglru": [],
                                                     "attention": []}
    saved = (ssm.ssd, rglru.rglru_scan, layers.flash_attention)
    ssm.ssd = ssd_both(saved[0], worst, seen["ssd"])
    rglru.rglru_scan = scan_both(saved[1], worst, seen["rglru"])
    layers.flash_attention = attention_both(saved[2], worst, seen["attention"])
    try:
        train_grads(cfg, params, batch, "reference")
    finally:
        ssm.ssd, rglru.rglru_scan, layers.flash_attention = saved
    counts = {k: len(v) for k, v in seen.items()}
    want = TRAIN_PATHS[cfg.name]
    check(counts == {"ssd": want.get(SSD_BWD_TC, 0),
                     "rglru": want.get("rglru_scan_bwd", 0),
                     "attention": want.get("flash_attn_bwd_dq", 0)},
          f"{cfg.name}: layer backwards compared {counts}")
    check(set(seen["ssd"] + seen["attention"]) == {torch.bfloat16},
          f"{cfg.name}: the compared layers did not run in bf16")
    shown = [k for kind, keys in (("ssd", ("dx", "ddt", "dA", "dB", "dC", "dD")),
                                  ("rglru", ("da", "du")),
                                  ("attention", ("dq", "dk", "dv")))
             if counts[kind] for k in keys]
    print(f"[parity] {cfg.name} every layer's backward in bf16, kernels vs "
          f"autograd through the plain versions on the plain path's "
          f"activations ({counts}, the output gradient at unit scale): max|err| "
          + ", ".join(f"{k} {worst[k]:.3e}" for k in shown)
          + f" (tol {BWD_TOL['bfloat16']:g}; the SSD's as SSD_BWD_TOL)")
    return counts


def grad_parity(device, arch: str) -> dict:
    """Kernel against plain in the model at full width and depth, one batch
    of GRAD_BATCH[arch] x 2048: one training step in f32 compute (loss and
    every gradient leaf gated at GRAD_RTOL of the leaf's largest |grad|,
    the plain path's spread under one f32 ulp of noise printed beside it),
    every layer's backward in bf16 (gated), the bf16 gradients end to end
    (printed, not gated).  Returns the f32-compute run's launches."""
    import torch
    from repro_torch.configs import ARCHS
    from repro_torch.data.pipeline import SyntheticTokens, shard_batch
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models.lm import init_params

    cfg = ARCHS[arch]
    params = init_params(cfg, torch.Generator(device).manual_seed(0),
                         trainable=True).tree()
    batch = shard_batch(SyntheticTokens(cfg.vocab, GRAD_BATCH[arch], PROMPT)
                        .next_batch(), device)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    LAUNCHES.clear()
    loss_k, g_k = train_grads(cfg32, params, batch, "auto")
    launches = dict(LAUNCHES)
    check(all(bool(torch.isfinite(g).all()) for g in g_k.values()),
          f"{arch}: f32-compute gradients of the kernel path are not finite")
    loss_p, g_p = train_grads(cfg32, params, batch, "reference")
    worst, key = worst_leaf(g_k, g_p)
    del g_k
    with ulp_noise(cfg32):
        loss_n, g_n = train_grads(cfg32, params, batch, "reference")
    floor, floor_key = worst_leaf(g_n, g_p)
    del g_n, g_p
    want = dict(TRAIN_PATHS[arch])
    if cfg.ssm:  # f32 x, B, C take the f32 path: ssd_chunk and PyTorch glue,
        # and the CUDA-core ssd_bwd_chunk
        for name in ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan"):
            want.pop(name)
        want["ssd_chunk"] = TRAIN_PATHS[arch]["ssd_chunk_scan"]
        want["ssd_bwd_chunk"] = want.pop(SSD_BWD_TC)
    check(launches == want, f"{arch} f32-compute step launched {launches}, "
          f"expected {want}")
    term = "SSD intra term" if cfg.ssm else "RG-LRU scan output" \
        if "rglru" in cfg.layer_kinds else "attention output"
    print(f"[parity] {cfg.name} float32 full-width training step (batch "
          f"{GRAD_BATCH[arch]} x {PROMPT}), kernels vs plain: loss {loss_k:.7f} "
          f"vs {loss_p:.7f} (|diff| {abs(loss_k - loss_p):.3e}); gradients, max "
          f"over leaves of max|diff| / max|grad|: {worst:.3e} at {key} (tol "
          f"{GRAD_RTOL:g}); plain vs plain with one f32 ulp of noise in its "
          f"{term} {floor:.3e} at {floor_key} (loss |diff| "
          f"{abs(loss_n - loss_p):.3e})")
    check(abs(loss_k - loss_p) <= GRAD_RTOL * abs(loss_p),
          f"{arch}: f32-compute losses of the kernel and plain paths disagree")
    check(worst <= GRAD_RTOL, f"{arch}: f32-compute gradients of the kernel "
          "and plain paths disagree")
    layer_grad_parity(cfg, params, batch)
    loss_k, g_k = train_grads(cfg, params, batch, "auto")
    loss_p, g_p = train_grads(cfg, params, batch, "reference")
    worst, key = worst_leaf(g_k, g_p)
    print(f"[parity] {cfg.name} bfloat16 full-width training step, kernels vs "
          f"plain (not gated): loss {loss_k:.7f} vs {loss_p:.7f}; gradients, "
          f"max over leaves of max|diff| / max|grad|: {worst:.3e} at {key}")
    del g_k, g_p, params
    torch.cuda.empty_cache()
    return launches


def serve_and_check(device, arch: str) -> dict:
    """Phase 4 for one model: the main path, its launch counts (each
    kernel of ``PATHS[arch]`` that many times per prefill round, no other
    kernel), and in-model parity of kernel against plain.  Returns the
    launch counts, and for the recurrent models under "f32 compute" those of
    the f32-compute logits gate."""
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
        LAUNCHES.clear()
        logit_parity(cfg32, model, batch, F32_LOGIT_ATOL, device)
        launches["f32 compute"] = dict(LAUNCHES)  # the gate's own launches
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
        with ulp_noise(cfg):
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
    spill_gate(logs)

    errs = kernel_vs_plain(device)
    ssd_err = ssd_kernel_vs_plain(device)
    ssd_bf16_errs = ssd_bf16_vs_plain(device)
    rglru_err = rglru_kernel_vs_plain(device)
    timings = {shape: kernel_timing(device, shape)
               for shape in (SERVE_SHAPE, RG_SERVE_SHAPE)}
    ssd_time = ssd_timing(device)
    ssd_bf16_time = ssd_bf16_timing(device)
    rglru_time = rglru_timing(device)
    bwd_errs = bwd_kernel_vs_plain(device)
    rglru_bwd_err = rglru_bwd_vs_plain(device)
    ssd_bwd_errs = ssd_bwd_vs_plain(device)
    functions_vs_autograd(device)
    bwd_time = bwd_timing(device)
    rg_bwd_time = bwd_timing(device, RG_TRAIN_SHAPE)
    rg1_bwd_time = bwd_timing(device, RG_TRAIN_SHAPE_B1)
    cluster_fwd_time = {shape: kernel_timing(device, shape)
                        for shape in CLUSTER_SHAPES}
    cluster_bwd_time = {shape: bwd_timing(device, shape)
                        for shape in CLUSTER_SHAPES}
    rglru_bwd_time = rglru_bwd_timing(device)
    ssd_bwd_time = ssd_bwd_timing(device)
    launches = {arch: serve_and_check(device, arch) for arch in PATHS}
    for arch in TRAIN_CELLS:
        key = f"{arch} training"
        launches[key] = train_and_check(device, arch)["launches"]
        launches[key]["f32 compute"] = grad_parity(device, arch)
    cluster = cluster_and_check(device)
    launches["physical mode"] = physical = cluster["launches"]
    trained_launches = [n for k, n in launches.items() if k.endswith("training")]
    trained_launches.append(physical)

    flash_shapes = [
        {"shape": list(shape), "path": arch,
         "launches": launches[arch].get("flash_attn_fwd", 0),
         "max_abs_err": errs[shape], **timings[shape]}
        for shape, arch in ((SERVE_SHAPE, "qwen3-0.6b"),
                            (RG_SERVE_SHAPE, "recurrentgemma-2b"))]
    flash_shapes.append({
        "shape": list(TRAIN_SHAPE), "path": "qwen3-0.6b training",
        "launches": launches["qwen3-0.6b training"]["flash_attn_fwd"],
        "ms_with_lse": bwd_time["flash_attn_bwd_dq"]["whole_backward"][
            "fwd_with_lse_ms"]})
    for shape, times, launched in (
            (RG_TRAIN_SHAPE, rg_bwd_time, 0),  # timed at 4; the cell runs 1
            (RG_TRAIN_SHAPE_B1, rg1_bwd_time,
             launches["recurrentgemma-2b training"]["flash_attn_fwd"])):
        flash_shapes.append({
            "shape": list(shape), "path": "recurrentgemma-2b training",
            "launches": launched,
            "ms": times["flash_attn_bwd_dq"]["whole_backward"]["fwd_ms"],
            "ms_with_lse": times["flash_attn_bwd_dq"]["whole_backward"][
                "fwd_with_lse_ms"]})
    # the physical mode's launches are counted over its jobs together
    # (physical_mode_launches), not a shape at a time
    flash_shapes += [{
        "shape": list(shape), "path": f"physical mode ({arch})",
        "max_abs_err": errs[shape], **cluster_fwd_time[shape]}
        for shape, (_, _, arch, _, _) in zip(CLUSTER_SHAPES, CLUSTER_JOBS)]
    flash_bwd = [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attn_bwd.cu",
        # no TPU kernel computes a gradient: these are the gradient of the
        # forward's TPU kernel
        "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
        "note": "no TPU counterpart: the gradient of flash_attention_pallas",
        "design": {
            "flash_attn_bwd_pre": "D = rowsum(dO o O), a warp a row",
            "flash_attn_bwd_dkdv": "a block per (batch x KV head, 64 keys) "
                                   "walks the group's heads and query tiles, "
                                   "dK and dV written once; bf16 at hd 16 and "
                                   "64: tensor cores (mma.sync m16n8k16, "
                                   "ldmatrix, two cp.async stages, P and dS "
                                   "in registers); bf16 at hd 256: eight "
                                   "warps (a row group and a column half "
                                   "each, P and dS through shared memory), "
                                   "the walk cut into bwd_splits parts whose "
                                   "f32 partials PyTorch sums; f32: CUDA "
                                   "cores",
            "flash_attn_bwd_dq": "a block per (batch x head, 64 queries) walks "
                                 "the key tiles; bf16 at hd 16 and 64: tensor "
                                 "cores as dkdv; bf16 at hd 256: eight warps "
                                 "as dkdv; f32: CUDA cores"}[name],
        # over the training paths and the physical mode; times at
        # qwen3-0.6b's training shape, the other shapes' under "shapes"
        "launches": sum(n.get(name, 0) for n in trained_launches),
        "physical_mode_launches": physical.get(name, 0),
        "max_abs_err": bwd_errs[TRAIN_SHAPE][name], **bwd_time[name],
        "shapes": [{"shape": list(shape), "path": "recurrentgemma-2b training",
                    "launches": launched, "max_abs_err": bwd_errs[shape][name],
                    **times[name]}
                   for shape, times, launched in (
                       (RG_TRAIN_SHAPE, rg_bwd_time, 0),  # the cell runs batch 1
                       (RG_TRAIN_SHAPE_B1, rg1_bwd_time, launches[
                           "recurrentgemma-2b training"].get(name, 0)))] + [
            {"shape": list(shape), "path": f"physical mode ({arch})",
             "max_abs_err": bwd_errs[shape][name],
             **cluster_bwd_time[shape][name]}
            for shape, (_, _, arch, _, _) in zip(CLUSTER_SHAPES, CLUSTER_JOBS)]}
        for name in BWD_KERNEL_NAMES]
    ssd_bwd = [{
        "name": name, "route": "cuda",
        # the training path's bf16 dS runs ssd_bf16.cu's tensor-core kernel,
        # its bf16 ssd_bwd_chunk ssd_bwd_tc.cu's
        "source": "src/repro_torch/kernels/ssd_scan/csrc/"
                  + {"ssd_bwd_dstate": "ssd_bf16.cu",
                     SSD_BWD_TC: "ssd_bwd_tc.cu"}.get(name, "ssd_bwd.cu"),
        # no TPU kernel computes a gradient: these are the gradient of the
        # forward's TPU kernel and its state passing
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:48",
        "note": "no TPU counterpart: the gradient of ssd_chunk_pallas and its "
                "state passing",
        "design": {
            "ssd_bwd_dstate": "bf16: tensor cores (csrc/ssd_bf16.cu: a block "
                              "per (batch x chunk, group, 6 heads), C staged "
                              "once, dy exp(cum) as hi + lo bf16, mma.sync "
                              "m16n8k16); f32: a block per (batch x chunk, "
                              "head), CUDA cores",
            "ssd_bwd_state_pass": "reverse recurrence over the chunks, 4 "
                                  "elements a thread, block partials of the "
                                  "chunk-end term",
            "ssd_bwd_chunk": "a block per (batch x chunk, 3 heads of a "
                             "group), 32-row tiles, dCB summed over the heads "
                             "in the block, dx in shared memory, dB and dC "
                             "block partials summed by PyTorch; CUDA cores, "
                             "f32; timed on the bf16 inputs that "
                             "ssd_bwd_chunk_tc now takes, and under f32_ on "
                             "f32 inputs, the only ones it still runs",
            SSD_BWD_TC: "bf16 inputs: tensor cores (mma.sync m16n8k16, "
                        "ldmatrix from swizzled shared memory, two cp.async "
                        "stages a head); a block per (batch x chunk, group, "
                        "head block), 8 warps each owning a 16-row strip in "
                        "two key rounds (dx, dB, key shares, products "
                        "transposed) and two query rounds (dC, query "
                        "shares); T, dCB, dchunk_in and h_in as hi + lo "
                        "bf16; dB and dC head-block partials summed by "
                        "PyTorch; no atomics"}[name],
        "launches": launches["mamba2-780m training"].get(name, 0),
        "f32_compute_launches":
            launches["mamba2-780m training"]["f32 compute"].get(name, 0),
        # mamba2-780m's job in the physical mode, at 2 x 32 (padded to one
        # chunk); its error at CLUSTER_SSD
        "physical_mode_launches": physical.get(name, 0),
        "physical_mode_max_abs_err": ssd_bwd_errs["physical mode"].get(name),
        "max_abs_err": ssd_bwd_errs.get(name), **ssd_bwd_time[name]}
        for name in SSD_BWD_KERNELS + (SSD_BWD_TC,)]
    # ssd_bwd_chunk's bf16 error comes from phase 3, its f32 one from phase 2
    ssd_bwd[SSD_BWD_KERNELS.index("ssd_bwd_chunk")]["f32_max_abs_err"] = \
        ssd_bwd_errs["ssd_bwd_chunk_f32"]
    ssd_bf16 = [{
        "name": name, "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_bf16.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:48",
        "design": {
            "ssd_chunk_state": "the chunk cumsum in PyTorch's order, then "
                               "tensor cores (mma.sync m16n8k16 bf16 -> f32; "
                               "x.w as hi + lo bf16; x by ldmatrix.trans)",
            "ssd_state_pass": "f32 recurrence over the chunks, 4 elements a "
                              "thread",
            "ssd_chunk_scan": "tensor cores (C.B^T once per warp in "
                              "registers; scores and h_in as hi + lo bf16; "
                              "two cp.async stages; y written once)"}[name],
        "launches": launches["mamba2-780m"].get(name, 0),
        "physical_mode_launches": physical.get(name, 0),
        "physical_mode_max_abs_err": ssd_bf16_errs["physical mode"][name],
        "max_abs_err": ssd_bf16_errs[name], **ssd_bf16_time[name]}
        for name in ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")]
    print("[cluster] " + json.dumps({k: v for k, v in cluster.items()
                                     if k != "launches"}))
    print(json.dumps({"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attn_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
        "design": "bf16: tensor cores (mma.sync m16n8k16 bf16 -> f32, ldmatrix "
                  "from swizzled shared memory, two cp.async K/V stages, P in "
                  "registers); f32: CUDA cores",
        # over every path that runs it; times at qwen3-0.6b's shape, each
        # other shape's own under "shapes"
        "launches": sum(n.get("flash_attn_fwd", 0) for n in launches.values()),
        "physical_mode_launches": physical.get("flash_attn_fwd", 0),
        "max_abs_err": max(errs.values()),
        "lse_max_abs_err": bwd_errs[TRAIN_SHAPE]["lse"],
        **timings[SERVE_SHAPE],
        "shapes": flash_shapes}, {
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan/kernel.py:48",
        "design": "f32 inputs: CUDA cores",
        # no served path runs it since bf16 went to ssd_bf16.cu; mamba2-780m's
        # f32-compute logits gate does
        "launches": launches["mamba2-780m"].get("ssd_chunk", 0),
        "f32_compute_launches":
            launches["mamba2-780m"]["f32 compute"].get("ssd_chunk", 0),
        "max_abs_err": ssd_err, **ssd_time}, *ssd_bf16, {
        "name": "rglru_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:41",
        "launches": launches["recurrentgemma-2b"].get("rglru_scan", 0),
        "training_launches":
            launches["recurrentgemma-2b training"].get("rglru_scan", 0),
        "max_abs_err": rglru_err, **rglru_time}, *flash_bwd, {
        "name": "rglru_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:41",
        "note": "no TPU counterpart: the gradient of rglru_scan_pallas",
        "design": "one thread per (batch, channel) walking t backward, 16 "
                  "steps of loads in flight, f32",
        "launches": launches["recurrentgemma-2b training"].get(
            "rglru_scan_bwd", 0),
        "max_abs_err": rglru_bwd_err, **rglru_bwd_time}, *ssd_bwd]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))  # the smoke drives cuda:0 alone
    return 0


if __name__ == "__main__":
    sys.exit(main())
