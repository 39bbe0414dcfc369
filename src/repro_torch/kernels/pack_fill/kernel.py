"""ctypes wrapper of the CUDA packing pass (``csrc/pack_fill.cu``), the port
of ``repro/core/engine_jax.py::_pack_all_types``: ``pack_fill`` checks its
CUDA tensors, allocates the outputs, launches one of the source's two
kernels and counts the launch under ``pack_fill`` (and under its variant in
``VARIANT_LAUNCHES``), or raises.  ``default_launch`` picks the kernel: the
warp kernel with the fewest classes a lane that covers the fleet, while
there are at most 16 workloads, else the block kernel.  ``ops.pack_all_types``
dispatches CPU tensors to the plain version instead.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Optional, Tuple

import torch

from .. import count_launch
from ..build import load

NAME = "pack_fill"
_DTYPES = {torch.float32: 0, torch.float64: 1}
MAX_THREADS = 512  # kMaxThreads of the .cu file
MAX_R = 4          # kMaxR
MAX_W = 16         # kMaxW: workloads the warp kernel keeps in registers
PER_LANE = (1, 2, 4, 8)  # the warp kernel's instantiations: classes a lane
SHARED_LIMIT = 232448  # bytes of shared memory a block may have on sm_90
# stats: records, whether some were not kept, greedy adds, fills tried
STATS = ("n_rec", "overflow", "adds", "fills")
# launches by variant ("warp L=<classes a lane>", "block"), beside LAUNCHES
VARIANT_LAUNCHES: "collections.Counter[str]" = collections.Counter()


def _lib():
    lib = load(NAME)
    lib.pack_fill.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 11
                              + [ctypes.c_void_p] * 7)
    lib.pack_fill_warp_shared_bytes.argtypes = [ctypes.c_int] * 3
    lib.pack_fill_warp_shared_bytes.restype = ctypes.c_size_t
    lib.pack_fill.restype = ctypes.c_int
    lib.pack_fill_shared_bytes.argtypes = [ctypes.c_int] * 5
    lib.pack_fill_shared_bytes.restype = ctypes.c_size_t
    lib.pack_fill_scratch_bytes.argtypes = [ctypes.c_int] * 2
    lib.pack_fill_scratch_bytes.restype = ctypes.c_size_t
    return lib


def block_threads(C: int) -> int:
    """The block kernel's threads: one a class, a multiple of 32, up to 512."""
    return min(MAX_THREADS, -(-C // 32) * 32)


def default_launch(C: int, W: int) -> Tuple[int, int]:
    """(classes a lane, threads) of the launch for C classes and W
    workloads: the warp kernel with the smallest of PER_LANE that covers C
    (32 threads) while W <= MAX_W, else the block kernel (0 classes a lane,
    ``block_threads(C)``)."""
    if W <= MAX_W:
        for per_lane in PER_LANE:
            if C <= 32 * per_lane:
                return per_lane, 32
    return 0, block_threads(C)


def variant_name(per_lane: int) -> str:
    return f"warp L={per_lane}" if per_lane else "block"


def _check(cdemand, cw, crp, cjr, counts0, rows_pad, P, logP, costs, caps,
           fams, rids, budget):
    C, F, R = cdemand.shape
    W, K = P.shape[0], costs.shape[0]
    floats = (cdemand, crp, cjr, P, logP, costs, caps)
    ints = (cw, counts0, rows_pad, fams, rids, budget)
    if cdemand.dtype not in _DTYPES or any(t.dtype != cdemand.dtype
                                           for t in floats):
        raise TypeError("cdemand, crp, cjr, P, logP, costs and caps must be "
                        "one dtype, float32 or float64: "
                        f"{[t.dtype for t in floats]}")
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("cw, counts0, rows_pad, fams, rids and budget must be "
                        f"int32: {[t.dtype for t in ints]}")
    shapes = {"cw": (cw, (C,)), "crp": (crp, (C,)), "cjr": (cjr, (C,)),
              "counts0": (counts0, (C,)), "P": (P, (W, W)),
              "logP": (logP, (W, W)), "caps": (caps, (K, R)),
              "fams": (fams, (K,)), "rids": (rids, (K,))}
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)} must be {want}")
    if rows_pad.dim() != 2 or rows_pad.shape[0] != C or budget.dim() != 1:
        raise ValueError(f"rows_pad {tuple(rows_pad.shape)} must be (C={C}, M) "
                         f"and budget {tuple(budget.shape)} one-dimensional")
    if C < 1 or K < 1 or W < 1 or rows_pad.shape[1] < 1 or budget.numel() < 1 \
            or not 1 <= R <= MAX_R:
        raise ValueError(f"bad sizes: C={C} K={K} W={W} R={R} "
                         f"M={rows_pad.shape[1]} NR={budget.numel()}")
    tensors = floats + ints
    if len({t.device for t in tensors}) != 1 or cdemand.device.type != "cuda":
        raise ValueError("every input must lie on one CUDA device: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("every input must be contiguous")


def pack_fill(cdemand, cw, crp, cjr, counts0, rows_pad, P, logP, costs, caps,
              fams, rids, budget, *, max_fills: int,
              per_lane: Optional[int] = None, threads: Optional[int] = None,
              stats: Optional[torch.Tensor] = None):
    """The pass on the card (``ref.pack_all_types_ref``'s arguments and
    results).  By default ``default_launch`` picks the kernel; for
    measurements ``per_lane`` (one of PER_LANE: the warp kernel, which then
    needs C <= 32 per_lane and W <= MAX_W; 0: the block kernel) and
    ``threads`` (the block kernel's, a multiple of 32 up to 512; by default
    ``block_threads``) pick it.  ``stats``, an int64 tensor of 4 on the
    card, receives ``STATS`` (n_rec and overflow are views of it)."""
    _check(cdemand, cw, crp, cjr, counts0, rows_pad, P, logP, costs, caps,
           fams, rids, budget)
    C, F, R = cdemand.shape
    W, K, M, NR = P.shape[0], costs.shape[0], rows_pad.shape[1], budget.numel()
    if per_lane is None:
        per_lane = default_launch(C, W)[0] if threads is None else 0
    if per_lane:
        if per_lane not in PER_LANE or C > 32 * per_lane or W > MAX_W \
                or threads not in (None, 32):
            raise ValueError(f"per_lane={per_lane}, threads={threads}: the "
                             f"warp kernel takes per_lane in {PER_LANE} with "
                             f"C={C} <= 32 per_lane and W={W} <= {MAX_W}, on "
                             "32 threads")
        threads = 32
    else:
        threads = block_threads(C) if threads is None else int(threads)
        if threads % 32 or not 32 <= threads <= MAX_THREADS:
            raise ValueError(f"threads={threads}: a multiple of 32 up to "
                             f"{MAX_THREADS}")
    if max_fills < 1:
        raise ValueError(f"max_fills={max_fills}")
    # the kernel indexes with these: workloads, families and regions in range
    lo, hi = (torch.stack([f(t) for t in (cw, fams, rids)]).tolist()
              for f in (torch.min, torch.max))
    if min(lo) < 0 or hi[0] >= W or hi[1] >= F or hi[2] >= NR:
        raise ValueError(f"cw, fams, rids span {list(zip(lo, hi))}, beyond "
                         f"W={W}, F={F}, NR={NR}")
    dev = cdemand.device
    if stats is None:
        stats = torch.empty(len(STATS), dtype=torch.int64, device=dev)
    elif (stats.dtype != torch.int64 or stats.shape != (len(STATS),)
          or stats.device != dev):
        raise ValueError("stats must be an int64 tensor of 4 on the inputs' card")
    lib = _lib()
    dtype = _DTYPES[cdemand.dtype]
    scratch = None
    if per_lane:
        if lib.pack_fill_warp_shared_bytes(dtype, W, NR) > SHARED_LIMIT:
            raise ValueError(f"NR={NR} regions exceed the kernel's shared "
                             "memory")
    elif lib.pack_fill_shared_bytes(dtype, C, W, NR, 1) > SHARED_LIMIT:
        if lib.pack_fill_shared_bytes(dtype, C, W, NR, 0) > SHARED_LIMIT:
            raise ValueError(f"W={W} workloads and NR={NR} regions exceed "
                             "the kernel's shared memory")
        scratch = torch.empty(lib.pack_fill_scratch_bytes(dtype, C),
                              dtype=torch.uint8, device=dev)
    budget_out = torch.empty_like(budget)
    rec_type = torch.full((max_fills,), -1, dtype=torch.int32, device=dev)
    rec_rep = torch.zeros(max_fills, dtype=torch.int32, device=dev)
    rec_comp = torch.zeros(max_fills, C, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.pack_fill(
            *(t.data_ptr() for t in (cdemand, cw, crp, cjr, counts0, rows_pad,
                                     P, logP, costs, caps, fams, rids, budget)),
            C, F, R, M, W, K, NR, max_fills, dtype, per_lane, threads,
            *(t.data_ptr() for t in (budget_out, rec_type, rec_rep, rec_comp,
                                     stats)),
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"{NAME} launch failed with CUDA error {err}")
    count_launch(NAME)
    VARIANT_LAUNCHES[variant_name(per_lane)] += 1
    return budget_out, rec_type, rec_rep, rec_comp, stats[0], stats[1] != 0
