"""ctypes wrapper of the CUDA SSD intra-chunk kernel (``csrc/ssd_chunk.cu``),
the port of ``ssd_chunk_pallas``.

On a CPU tensor the wrapper computes the kernel's plain version
(``ref.ssd_chunk_ref``); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .. import LAUNCHES
from ..build import load
from .ref import ssd_chunk_ref

NAME = "ssd_chunk"
# (head dim P, state N) instantiated in the .cu file: (16, 16) the reduced
# configs', (16, 32) and (32, 16) the test grid's, (64, 128) mamba2-780m's
PN_PAIRS = ((16, 16), (16, 32), (32, 16), (64, 128))
MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_Y = 65535


def _function():
    fn = load(NAME).ssd_chunk
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, dt, cum, B, C, chunk):
    if x.dim() != 4 or dt.dim() != 3 or cum.dim() != 3 or B.dim() != 4 \
            or C.dim() != 4:
        raise ValueError("x must be (Bt, S, H, P), dt and cum (Bt, S, H), "
                         "B and C (Bt, S, G, N)")
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if dt.shape != (Bt, S, H) or cum.shape != (Bt, S, H) \
            or B.shape != (Bt, S, G, N) or C.shape != B.shape:
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, cum {tuple(cum.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if Bt < 1 or S < 1 or G < 1 or H % G:
        raise ValueError(f"bad sizes or head counts: Bt={Bt} S={S} H={H} G={G}")
    if (P, N) not in PN_PAIRS:
        raise ValueError(f"(P, N) = ({P}, {N}) is not instantiated in the "
                         f"kernel; it takes {PN_PAIRS}")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"chunk {chunk} must lie in 1..{MAX_CHUNK} and divide "
                         f"S={S} (ops.ssd pads to a chunk multiple)")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"dtypes {x.dtype}, {B.dtype}, {C.dtype}: x, B and C "
                        "must be float32 or bfloat16, the same for all three")
    if dt.dtype != torch.float32 or cum.dtype != torch.float32:
        raise TypeError(f"dt and cum must be float32, got {dt.dtype}, {cum.dtype}")
    tensors = (x, dt, cum, B, C)
    if len({t.device for t in tensors}) != 1 or x.device.type != "cuda":
        raise ValueError("x, dt, cum, B, C must lie on one CUDA device: "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, dt, cum, B, C must be contiguous")
    if S // chunk > _MAX_GRID_Y or Bt * H >= 2 ** 31:
        raise ValueError(f"S/chunk={S // chunk}, Bt*H={Bt * H} exceed the "
                         "kernel's grid")


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, cum: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, *, chunk: int):
    """x: (Bt, S, H, P); dt, cum: (Bt, S, H) f32; B, C: (Bt, S, G, N).

    Returns (y_intra (Bt, S, H, P), chunk_in (Bt, S/chunk, H, P, N)), f32."""
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, dt, cum, B, C, chunk=chunk)
    _check(x, dt, cum, B, C, chunk)
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc = S // chunk
    y = torch.empty(Bt, S, H, P, dtype=torch.float32, device=x.device)
    chunk_in = torch.empty(Bt, nc, H, P, N, dtype=torch.float32, device=x.device)
    fn = _function()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), cum.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(), chunk_in.data_ptr(),
                 Bt, S, H, G, P, N, chunk, _DTYPES[x.dtype], stream)
    if err:
        raise RuntimeError(f"{NAME} launch failed with CUDA error {err}")
    LAUNCHES[NAME] += 1
    return y, chunk_in
