"""RG-LRU scan entry point (``repro/kernels/rglru_scan/ops.py``).  The
kernel's wrapper launches the CUDA kernel on a CUDA tensor and computes the
plain version on a CPU tensor; the device is looked at there and nowhere
else."""
from __future__ import annotations

from .kernel import rglru_scan_fwd
from .ref import rglru_scan_assoc, rglru_scan_ref

__all__ = ["rglru_scan"]


def rglru_scan(a, u, h0=None, *, impl: str = "auto"):
    """h_t = a_t h_{t-1} + u_t over axis 1.  Returns (h_seq in u's dtype,
    h_final f32).

    ``impl="auto"``: the kernel's wrapper; ``"sequential"``:
    ``rglru_scan_ref``; ``"reference"``: ``rglru_scan_assoc``, the model's
    plain path."""
    if impl == "auto":
        return rglru_scan_fwd(a.contiguous(), u.contiguous(),
                              None if h0 is None else h0.contiguous())
    if impl == "sequential":
        return rglru_scan_ref(a, u, h0)
    if impl == "reference":
        return rglru_scan_assoc(a, u, h0)
    raise ValueError(f"unknown impl {impl!r}")
