"""RG-LRU scan entry point (``repro/kernels/rglru_scan/ops.py``).  The
kernels' wrappers launch the CUDA kernels on a CUDA tensor and compute the
plain versions on a CPU tensor; the device is looked at there and nowhere
else.  Where a gradient is wanted on the card, ``RGLRUScan`` pairs the scan
kernel with its backward kernel; on the CPU the plain version is
differentiated by autograd, as the reference differentiates its jnp scan off
its accelerator.  Given DTensors (under a mesh), it runs on each rank's shards
of the batch and the channels (``kernels.shards``)."""
from __future__ import annotations

import torch

from ..shards import Arg, is_dtensor, on_shards
from .kernel import rglru_scan_bwd, rglru_scan_fwd
from .ref import rglru_scan_assoc, rglru_scan_ref

__all__ = ["RGLRUScan", "rglru_scan"]


class RGLRUScan(torch.autograd.Function):
    """The scan through the kernels: the forward saves a and every state in
    f32 (never the bf16-rounded h_seq); the backward launches the backward
    kernel on them (the wrappers' plain versions on a CPU tensor)."""

    @staticmethod
    def forward(ctx, a, u, h0):
        hs, h_final, h_state = rglru_scan_fwd(a, u, h0, return_state=True)
        ctx.save_for_backward(a, h_state, h0)
        ctx.set_materialize_grads(False)
        return hs, h_final

    @staticmethod
    def backward(ctx, dhs, dh_final):
        a, h_state, h0 = ctx.saved_tensors
        dhs = torch.zeros_like(a) if dhs is None else dhs.to(a.dtype).contiguous()
        if dh_final is not None:
            dh_final = dh_final.float().contiguous()
        da, du, dh0 = rglru_scan_bwd(a, h_state, h0, dhs, dh_final)
        return da, du, dh0 if h0 is not None else None


def rglru_scan(a, u, h0=None, *, impl: str = "auto"):
    """h_t = a_t h_{t-1} + u_t over axis 1.  Returns (h_seq in u's dtype,
    h_final f32).

    ``impl="auto"``: the kernel's wrapper, through ``RGLRUScan`` when grad
    is enabled and an input on the card requires it; ``"sequential"``:
    ``rglru_scan_ref``; ``"reference"``: ``rglru_scan_assoc``, the model's
    plain path."""
    if is_dtensor(a):
        seq, state = {"batch": 0, "heads": 2}, {"batch": 0, "heads": 1}
        return on_shards(lambda a, u, h0: rglru_scan(a, u, h0, impl=impl), a,
                         seq, [Arg(a, seq), Arg(u, seq), Arg(h0, state)],
                         [seq, state])
    if impl == "auto":
        args = (a.contiguous(), u.contiguous(),
                None if h0 is None else h0.contiguous())
        if a.device.type != "cpu" and torch.is_grad_enabled() \
                and any(t is not None and t.requires_grad for t in (a, u, h0)):
            return RGLRUScan.apply(*args)
        return rglru_scan_fwd(*args)
    if impl == "sequential":
        return rglru_scan_ref(a, u, h0)
    if impl == "reference":
        return rglru_scan_assoc(a, u, h0)
    raise ValueError(f"unknown impl {impl!r}")
