"""Entry point of the packing pass, as ``core/engine_torch.py`` calls it:
CUDA tensors launch ``csrc/pack_fill.cu`` through its wrapper (which raises
on what the kernel does not take), CPU tensors run the plain version,
``ref.pack_all_types_ref``.  The device is looked at here and nowhere else;
no path falls back."""
from __future__ import annotations

from .kernel import pack_fill
from .ref import pack_all_types_ref

__all__ = ["pack_all_types"]


def pack_all_types(cdemand, cw, crp, cjr, counts0, rows_pad, P, logP, costs,
                   caps, fams, rids, budget, *, max_fills: int):
    """``repro/core/engine_jax.py::_pack_all_types``'s arguments and
    results: (budget, rec_type, rec_rep, rec_comp, n_rec, overflow)."""
    args = (cdemand, cw, crp, cjr, counts0, rows_pad, P, logP, costs, caps,
            fams, rids, budget)
    if cdemand.device.type == "cpu":
        return pack_all_types_ref(*args, max_fills=max_fills)
    return pack_fill(*args, max_fills=max_fills)
