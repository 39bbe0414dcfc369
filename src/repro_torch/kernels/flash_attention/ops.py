"""Attention entry point (``repro/kernels/flash_attention/ops.py``): the
contiguous case goes to the kernel's wrapper, which launches the CUDA kernel
on a CUDA tensor and computes the plain version on a CPU tensor; the device
is looked at there and nowhere else."""
from __future__ import annotations

from typing import Optional

from .kernel import flash_attention_fwd
from .ref import attention_chunked, attention_ref


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    q_positions=None, k_positions=None, impl: str = "auto"):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KH, hd).

    ``impl="auto"``: the kernel's wrapper for contiguous positions with
    Sq == Sk, the plain version otherwise, as in the reference.
    ``impl="kernel"`` insists on the wrapper and raises on what it cannot take.
    ``impl="reference"`` is the non-kernel path on any device, as in the
    reference: decode (explicit positions, one query) is a masked matvec with
    no kernel, and long contiguous sequences take the query-blocked version.
    """
    contiguous = q_positions is None and k_positions is None \
        and q.shape[1] == k.shape[1]
    if impl == "auto":
        impl = "kernel" if contiguous else "reference"
    if impl == "kernel":
        if not contiguous:
            raise ValueError("the attention kernel takes contiguous positions "
                             "with Sq == Sk; pass impl='reference' for decode")
        return flash_attention_fwd(q, k, v, causal=causal, window=window)
    if impl != "reference":
        raise ValueError(f"unknown impl {impl!r}")
    if contiguous and q.shape[1] > 512:
        return attention_chunked(q, k, v, causal=causal, window=window)
    return attention_ref(q, k, v, causal=causal, window=window,
                         q_positions=q_positions, k_positions=k_positions)
