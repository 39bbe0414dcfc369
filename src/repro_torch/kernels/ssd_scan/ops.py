"""SSD entry point (``repro/kernels/ssd_scan/ops.py``): the intra-chunk
kernel's wrapper plus state passing between chunks.  The wrapper launches
the CUDA kernel on a CUDA tensor and computes the plain version on a CPU
tensor; the device is looked at there and nowhere else."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .kernel import ssd_chunk
from .ref import (carry, chunk_cumsum, pass_states, ssd_chunked_ref,
                  ssd_decode_step, ssd_ref)

__all__ = ["ssd", "ssd_decode_step"]


def ssd(x, dt, A, B, C, D, *, chunk: int = 256, h0=None, impl: str = "auto"):
    """Mamba2 SSD forward.  x: (Bt, S, H, P); dt: (Bt, S, H); A, D: (H,);
    B, C: (Bt, S, G, N).  Returns (y in x's dtype, h_final (Bt, H, P, N) f32).

    ``impl="auto"``: the kernel's wrapper for the intra-chunk term;
    ``"reference"``: ``ssd_chunked_ref``; ``"sequential"``: ``ssd_ref``."""
    if impl not in ("auto", "reference", "sequential"):
        raise ValueError(f"unknown impl {impl!r}")
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

    dtf = dt.float().contiguous()
    cum = chunk_cumsum(dtf, A, chunk)
    y_intra, chunk_in = ssd_chunk(x.contiguous(), dtf, cum, B.contiguous(),
                                  C.contiguous(), chunk=chunk)
    h_ins, h_final = pass_states(chunk_in, torch.exp(cum[:, chunk - 1::chunk]),
                                 h0)
    y = y_intra + carry(C, h_ins, cum, chunk=chunk) + x.float() * D[:, None]
    return y.to(x.dtype), h_final
