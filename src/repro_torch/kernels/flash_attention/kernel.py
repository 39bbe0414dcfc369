"""ctypes wrapper of the CUDA flash-attention forward kernel
(``csrc/flash_attn_fwd.cu``), the port of ``flash_attention_pallas``.

On a CPU tensor the wrapper computes the kernel's plain version
(``ref.attention_ref``); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from .. import LAUNCHES
from ..build import load
from .ref import attention_ref

NAME = "flash_attn_fwd"
# 16 is the reduced configs', 64 qwen3-0.6b's, 256 recurrentgemma-2b's
HEAD_DIMS = (16, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


def _block_q(hd: int) -> int:
    """Query rows per block, as in the .cu file."""
    return 16 if hd == 256 else 64


def _function():
    fn = load(NAME).flash_attn_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-d: q (B, S, H, hd), k/v (B, S, KH, hd)")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}: the kernel takes self-attention, Sq == Sk")
    KH = k.shape[2]
    if B < 1 or S < 1 or KH < 1 or H % KH:
        raise ValueError(f"bad head counts or sizes: B={B} S={S} H={H} KH={KH}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not supported by the kernel; it takes {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes {q.dtype}, {k.dtype}, {v.dtype}: the kernel takes "
                        "float32 or bfloat16, the same for q, k and v")
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(f"q, k, v must lie on one CUDA device: {q.device}, "
                         f"{k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if -(-S // _block_q(hd)) > _MAX_GRID_Y or B * H >= 2 ** 31:
        raise ValueError(f"S={S}, B*H={B * H} exceed the kernel's grid")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, S, KH, hd) -> (B, S, H, hd) in q's dtype."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    _check(q, k, v, window)
    B, S, H, hd = q.shape
    o = torch.empty_like(q)
    fn = _function()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, S, H, k.shape[2], hd, _DTYPES[q.dtype], 1.0 / hd ** 0.5,
                 int(causal), window or 0, stream)
    if err:
        raise RuntimeError(f"{NAME} launch failed with CUDA error {err}")
    LAUNCHES[NAME] += 1
    return o
