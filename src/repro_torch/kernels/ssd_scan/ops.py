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
Where a gradient is wanted on the card, ``SSDScan`` pairs either path with
the backward kernels (``csrc/ssd_bwd.cu`` for f32; for bf16 the tensor-core
``ssd_bwd_dstate`` of ``csrc/ssd_bf16.cu`` and ``ssd_bwd_chunk`` of
``csrc/ssd_bwd_tc.cu``); on the CPU the plain versions are differentiated by
autograd, as the reference differentiates its jnp path off its
accelerator.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import (ssd_bwd_chunk, ssd_bwd_dstate, ssd_bwd_state_pass,
                     ssd_chunk, ssd_chunk_scan, ssd_chunk_state, ssd_state_pass)
from .ref import (chunk_cumsum, combine, pass_states, ssd_chunked_ref,
                  ssd_decode_step, ssd_ref)

__all__ = ["SSDScan", "ssd", "ssd_decode_step"]


class SSDScan(torch.autograd.Function):
    """The whole SSD through the kernels, S % chunk == 0: the forward runs
    ``_fused`` (bf16) or ``_intra_then_pass`` (f32) and saves x, dt, A, B, C,
    D, the within-chunk cumsum and the state entering each chunk (f32); the
    backward launches ``ssd_bwd_dstate``, ``ssd_bwd_state_pass`` and
    ``ssd_bwd_chunk`` on them (the wrappers' plain versions on a CPU
    tensor) and returns the gradients of x, dt, A, B, C, D and h0."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, h0, chunk: int):
        x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
        dtf, Af, Df = (t.float().contiguous() for t in (dt, A, D))
        path = _fused if x.dtype == torch.bfloat16 else _intra_then_pass
        y, h_final, cum, h_ins = path(x, dtf, Af, B, C, Df, chunk=chunk, h0=h0)
        ctx.save_for_backward(x, dtf, Af, B, C, Df, cum, h_ins)
        ctx.chunk, ctx.has_h0 = chunk, h0 is not None
        ctx.dtypes = (dt.dtype, A.dtype, D.dtype)
        ctx.set_materialize_grads(False)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, dh_final):
        x, dt, A, B, C, D, cum, h_ins = ctx.saved_tensors
        chunk = ctx.chunk
        dy = torch.zeros_like(x) if dy is None else dy.to(x.dtype).contiguous()
        if dh_final is not None:
            dh_final = dh_final.float().contiguous()
        dS = ssd_bwd_dstate(dy, cum, C, chunk=chunk)
        dchunk_in, dh0, end = ssd_bwd_state_pass(dS, cum, h_ins, dh_final,
                                                 chunk=chunk)
        dx, ddt, dA, dB, dC, dD = ssd_bwd_chunk(x, dt, A, cum, B, C, D, dy,
                                                h_ins, dchunk_in, end,
                                                chunk=chunk)
        dt_dtype, A_dtype, D_dtype = ctx.dtypes
        return (dx, ddt.to(dt_dtype), dA.to(A_dtype), dB.to(B.dtype),
                dC.to(C.dtype), dD.to(D_dtype), dh0 if ctx.has_h0 else None,
                None)


def ssd(x, dt, A, B, C, D, *, chunk: int = 256, h0=None, impl: str = "auto"):
    """Mamba2 SSD forward.  x: (Bt, S, H, P) f32 or bf16; dt: (Bt, S, H); A,
    D: (H,); B, C: (Bt, S, G, N).  Returns (y in x's dtype, h_final
    (Bt, H, P, N) f32).

    ``impl="auto"``: the kernels' wrappers (``_fused`` for bf16,
    ``_intra_then_pass`` for f32), through ``SSDScan`` when grad is enabled
    and an input on the card requires it; ``"reference"``:
    ``ssd_chunked_ref``; ``"sequential"``: ``ssd_ref``."""
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
    if x.device.type != "cpu" and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, dt, A, B, C, D, h0)):
        return SSDScan.apply(x, dt, A, B, C, D, h0, chunk)
    path = _fused if x.dtype == torch.bfloat16 else _intra_then_pass
    return path(x, dt, A, B, C, D, chunk=chunk, h0=h0)[:2]


def _fused(x, dt, A, B, C, D, *, chunk: int, h0=None):
    """bf16, S % chunk == 0: ``ssd_chunk_state``, ``ssd_state_pass`` and
    ``ssd_chunk_scan``.  Returns (y, h_final, cum, h_ins)."""
    dtf = dt.float().contiguous()
    x, B, C = x.contiguous(), B.contiguous(), C.contiguous()
    chunk_in, cum = ssd_chunk_state(x, dtf, A.float().contiguous(), B,
                                    chunk=chunk)
    h_ins, h_final = ssd_state_pass(
        chunk_in, cum, None if h0 is None else h0.float().contiguous(),
        chunk=chunk)
    y = ssd_chunk_scan(x, dtf, cum, B, C, D.float().contiguous(), h_ins,
                       chunk=chunk)
    return y, h_final, cum, h_ins


def _intra_then_pass(x, dt, A, B, C, D, *, chunk: int, h0=None):
    """S % chunk == 0: the intra-chunk kernel ``ssd_chunk``, then the state
    passing, carry and D skip in PyTorch (the f32 path; in bf16 the path
    that ``_fused`` replaced, kept for f32 and for comparison).  Returns
    (y, h_final, cum, h_ins)."""
    dtf = dt.float().contiguous()
    cum = chunk_cumsum(dtf, A, chunk)
    y_intra, chunk_in = ssd_chunk(x.contiguous(), dtf, cum, B.contiguous(),
                                  C.contiguous(), chunk=chunk)
    h_ins, h_final = pass_states(chunk_in, torch.exp(cum[:, chunk - 1::chunk]),
                                 h0)
    return (combine(x, y_intra, C, h_ins, cum, D, chunk=chunk), h_final, cum,
            h_ins)
