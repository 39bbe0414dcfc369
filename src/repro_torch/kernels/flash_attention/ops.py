"""Attention entry point (``repro/kernels/flash_attention/ops.py``): the
contiguous case goes to the kernel's wrapper, which launches the CUDA kernel
on a CUDA tensor and computes the plain version on a CPU tensor.  Where a
gradient is wanted on the card, ``FlashAttention`` pairs the forward kernel
with the backward kernels; on the CPU the plain version is differentiated
by autograd, as the reference differentiates its jnp path off its
accelerator.  Given DTensors (under a mesh), it runs on each rank's shards
of the batch and the heads (``kernels.shards``)."""
from __future__ import annotations

from typing import Optional

import torch

from ..shards import Arg, is_dtensor, on_shards
from .kernel import flash_attention_bwd, flash_attention_fwd
from .ref import attention_chunked, attention_ref


class FlashAttention(torch.autograd.Function):
    """Self-attention through the kernels: the forward saves q, k, v, the
    output and its log-sum-exp; the backward launches the backward kernels
    on them (the wrappers' plain versions on a CPU tensor)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                     return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window = causal, window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    q_positions=None, k_positions=None, impl: str = "auto"):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KH, hd).

    ``impl="auto"``: the kernel's wrapper for contiguous positions with
    Sq == Sk, the plain version otherwise, as in the reference.
    ``impl="kernel"`` insists on the wrapper and raises on what it cannot take;
    when grad is enabled and an input on the card requires it, the call goes
    through ``FlashAttention`` (forward and backward kernels).
    ``impl="reference"`` is the non-kernel path on any device, as in the
    reference, differentiated by autograd: decode (explicit positions, one
    query) is a masked matvec with no kernel, and long contiguous sequences
    take the query-blocked version.
    """
    if is_dtensor(q):
        H, KH = q.shape[2], k.shape[2]
        kv = {"batch": 0, "heads": 2}
        return on_shards(
            lambda q, k, v, qp, kp: flash_attention(
                q, k, v, causal=causal, window=window, q_positions=qp,
                k_positions=kp, impl=impl),
            q, kv, [Arg(q, kv), Arg(k, kv, (KH, H)), Arg(v, kv, (KH, H)),
                    Arg(q_positions, {}), Arg(k_positions, {})], [kv])
    contiguous = q_positions is None and k_positions is None \
        and q.shape[1] == k.shape[1]
    if impl == "auto":
        impl = "kernel" if contiguous else "reference"
    if impl == "kernel":
        if not contiguous:
            raise ValueError("the attention kernel takes contiguous positions "
                             "with Sq == Sk; pass impl='reference' for decode")
        if q.device.type != "cpu" and torch.is_grad_enabled() \
                and (q.requires_grad or k.requires_grad or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window)
        return flash_attention_fwd(q, k, v, causal=causal, window=window)
    if impl != "reference":
        raise ValueError(f"unknown impl {impl!r}")
    if contiguous and q.shape[1] > 512:
        return attention_chunked(q, k, v, causal=causal, window=window)
    return attention_ref(q, k, v, causal=causal, window=window,
                         q_positions=q_positions, k_positions=k_positions)
