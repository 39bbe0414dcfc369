"""ctypes wrapper of the CUDA RG-LRU scan kernel (``csrc/rglru_scan.cu``),
the port of ``rglru_scan_pallas``.

On a CPU tensor the wrapper computes the kernel's plain version
(``ref.rglru_scan_ref``); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import LAUNCHES
from ..build import load
from .ref import rglru_scan_ref

NAME = "rglru_scan"
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 64  # channels per block, as in the .cu file
_MAX_GRID_Y = 65535


def _function():
    fn = load(NAME).rglru_scan
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(a, u, h0):
    if a.dim() != 3 or a.shape != u.shape:
        raise ValueError(f"a {tuple(a.shape)} and u {tuple(u.shape)} must be "
                         "(B, S, R), the same shape")
    B, S, R = a.shape
    if B < 1 or S < 1 or R < 1:
        raise ValueError(f"bad sizes: B={B} S={S} R={R}")
    if a.dtype not in _DTYPES or u.dtype != a.dtype:
        raise TypeError(f"dtypes {a.dtype}, {u.dtype}: the kernel takes "
                        "float32 or bfloat16, the same for a and u")
    tensors = (a, u) if h0 is None else (a, u, h0)
    if h0 is not None:
        if h0.shape != (B, R):
            raise ValueError(f"h0 {tuple(h0.shape)} must be (B, R) = ({B}, {R})")
        if h0.dtype != torch.float32:
            raise TypeError(f"h0 must be float32, got {h0.dtype}")
    if len({t.device for t in tensors}) != 1 or a.device.type != "cuda":
        raise ValueError("a, u and h0 must lie on one CUDA device: "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("a, u and h0 must be contiguous")
    if B > _MAX_GRID_Y or -(-R // _THREADS) >= 2 ** 31:
        raise ValueError(f"B={B}, R={R} exceed the kernel's grid")


def rglru_scan_fwd(a: torch.Tensor, u: torch.Tensor,
                   h0: Optional[torch.Tensor] = None):
    """a, u: (B, S, R); h0: (B, R) f32 or None (zeros).

    Returns (h_seq (B, S, R) in u's dtype, h_final (B, R) f32)."""
    if a.device.type == "cpu":
        return rglru_scan_ref(a, u, h0)
    _check(a, u, h0)
    B, S, R = a.shape
    hs = torch.empty_like(u)
    h_final = torch.empty(B, R, dtype=torch.float32, device=a.device)
    fn = _function()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), u.data_ptr(), None if h0 is None else h0.data_ptr(),
                 hs.data_ptr(), h_final.data_ptr(), B, S, R, _DTYPES[a.dtype],
                 stream)
    if err:
        raise RuntimeError(f"{NAME} launch failed with CUDA error {err}")
    LAUNCHES[NAME] += 1
    return hs, h_final
