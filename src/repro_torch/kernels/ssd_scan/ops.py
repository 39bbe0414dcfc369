"""SSD entry point (``repro/kernels/ssd_scan/ops.py``).

The input type picks the path, and each kernel's wrapper picks kernel or
plain version by the device (a CUDA tensor launches the kernel or raises, a
CPU tensor takes the plain version; the device is looked at there and
nowhere else):
- bf16: ``_fused``, the whole SSD in three kernels (the within-chunk
  cumsum with the chunk states, the state passing, the intra term with the
  carry and D skip; the products on the tensor cores), y written once;
- f32: ``_intra_then_pass``, the CUDA-core intra-chunk kernel with the state
  passing, carry and D skip in PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import ssd_chunk, ssd_chunk_scan, ssd_chunk_state, ssd_state_pass
from .ref import (chunk_cumsum, combine, pass_states, ssd_chunked_ref,
                  ssd_decode_step, ssd_ref)

__all__ = ["ssd", "ssd_decode_step"]


def ssd(x, dt, A, B, C, D, *, chunk: int = 256, h0=None, impl: str = "auto"):
    """Mamba2 SSD forward.  x: (Bt, S, H, P) f32 or bf16; dt: (Bt, S, H); A,
    D: (H,); B, C: (Bt, S, G, N).  Returns (y in x's dtype, h_final
    (Bt, H, P, N) f32).

    ``impl="auto"``: the kernels' wrappers (``_fused`` for bf16,
    ``_intra_then_pass`` for f32); ``"reference"``: ``ssd_chunked_ref``;
    ``"sequential"``: ``ssd_ref``."""
    if impl not in ("auto", "reference", "sequential"):
        raise ValueError(f"unknown impl {impl!r}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x is {x.dtype}; ssd takes float32 or bfloat16")
    if impl == "sequential":
        return ssd_ref(x, dt, A, B, C, D, h0=h0)
    S = x.shape[1]
    pad = (-S) % chunk
    if pad:
        # dt = 0 padding: decay exp(A·0) = 1 and zero input leave the state
        # untouched, so trailing pad steps are inert.
        def zp(a):
            return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        y, h = ssd(zp(x), zp(dt), A, zp(B), zp(C), D, chunk=chunk, h0=h0,
                   impl=impl)
        return y[:, :S], h
    if impl == "reference":
        return ssd_chunked_ref(x, dt, A, B, C, D, chunk=chunk, h0=h0)
    path = _fused if x.dtype == torch.bfloat16 else _intra_then_pass
    return path(x, dt, A, B, C, D, chunk=chunk, h0=h0)


def _fused(x, dt, A, B, C, D, *, chunk: int, h0=None):
    """bf16, S % chunk == 0: ``ssd_chunk_state``, ``ssd_state_pass`` and
    ``ssd_chunk_scan``."""
    dtf = dt.float().contiguous()
    x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
    chunk_in, cum = ssd_chunk_state(x, dtf, A.float().contiguous(), B,
                                    chunk=chunk)
    h_ins, h_final = ssd_state_pass(
        chunk_in, cum, None if h0 is None else h0.float().contiguous(),
        chunk=chunk)
    y = ssd_chunk_scan(x, dtf, cum, B, C, D.float().contiguous(), h_ins,
                       chunk=chunk)
    return y, h_final


def _intra_then_pass(x, dt, A, B, C, D, *, chunk: int, h0=None):
    """S % chunk == 0: the intra-chunk kernel ``ssd_chunk``, then the state
    passing, carry and D skip in PyTorch (the f32 path; in bf16 the path
    that ``_fused`` replaced, kept for f32 and for comparison)."""
    dtf = dt.float().contiguous()
    cum = chunk_cumsum(dtf, A, chunk)
    y_intra, chunk_in = ssd_chunk(x.contiguous(), dtf, cum, B.contiguous(),
                                  C.contiguous(), chunk=chunk)
    h_ins, h_final = pass_states(chunk_in, torch.exp(cum[:, chunk - 1::chunk]),
                                 h0)
    return combine(x, y_intra, C, h_ins, cum, D, chunk=chunk), h_final
