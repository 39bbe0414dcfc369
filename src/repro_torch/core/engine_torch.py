"""Fleet-scale packing engine of the port (``repro/core/engine_jax.py``):
Algorithm 1 over *task classes*, the whole descending-cost type loop in one
device program.

The host side is the reference's numpy, kept under its names:
``_collapse_classes`` groups interchangeable tasks (identical workload, RP,
job-RP and demand; across workloads too when the pairwise matrix is
all-ones) into classes with multiplicity counts, and ``pack_torch`` pads the
classes and their row queues to powers of two (``pass_inputs``), runs the
pass, doubles the record buffer until nothing overflows, and expands the
fill records back to task rows.  The pass itself is
``kernels.pack_fill.ops.pack_all_types``: on the card one launch of
``csrc/pack_fill.cu`` (the reference's jitted
``lax`` program, whose loops end on data, so that torch operations would
need a host round trip for every greedy add), on the CPU its plain version.

The arithmetic dtype is ``torch.get_default_dtype()`` (float32 unless a
caller sets float64), as the reference's is JAX's canonical float dtype.
``pack_torch`` consumes ``region_budget`` in place, as the numpy and python
packers do.

One repair against the reference: where price or demand keys vary within
a workload (per-job RP sums of multi-task jobs), the reference's
``_collapse_classes`` calls ``np.unique(..., return_inverse=True)`` without
``return_index=True`` and fails to unpack its result; this copy asks for the
index that the code after it uses.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..obs import profiler as _prof
from .catalog import Catalog

_BIG_I = np.int32(np.iinfo(np.int32).max // 2)  # headroom for decrements
_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _collapse_classes(workloads: np.ndarray, rp: np.ndarray, jr: np.ndarray,
                      demand: np.ndarray, merge_workloads: bool):
    """Group interchangeable tasks into classes.

    Returns ``(inv, cw, crp, cjr, cdemand, counts)`` where ``inv`` maps each
    task row to its class.  Fast path: when price/demand vectors are constant
    per workload (the common case — demands come from the workload profile
    and RP is a function of demand), classes are just the workloads present
    (further merged across workloads when ``merge_workloads`` — i.e. the
    pairwise matrix is all-ones and workload identity is inert).
    """
    T = workloads.shape[0]
    d2 = np.ascontiguousarray(demand.reshape(T, -1), dtype=np.float64)
    cols = np.column_stack([rp.astype(np.float64), jr.astype(np.float64), d2])
    order = np.argsort(workloads, kind="stable")
    ws = workloads[order]
    starts = np.nonzero(np.concatenate([[True], ws[1:] != ws[:-1]]))[0]
    grouped = cols[order]
    lo = np.minimum.reduceat(grouped, starts, axis=0)
    hi = np.maximum.reduceat(grouped, starts, axis=0)
    if np.array_equal(lo, hi):
        present = ws[starts]  # distinct workloads, ascending
        remap = np.zeros(int(workloads.max()) + 1, dtype=np.int64)
        remap[present] = np.arange(present.size)
        inv = remap[workloads]
        keys, cw = lo, present.astype(np.int64)
        if merge_workloads:
            _, uidx, uinv = np.unique(keys, axis=0, return_index=True,
                                      return_inverse=True)
            inv = uinv.reshape(-1)[inv]
            cw = cw[uidx]
            keys = keys[uidx]
    else:  # per-workload keys vary (e.g. per-job RP sums): full row unique
        full = cols if merge_workloads else np.column_stack(
            [workloads.astype(np.float64), cols])
        _, uidx, inv = np.unique(full, axis=0, return_index=True,
                                 return_inverse=True)
        inv = inv.reshape(-1)
        cw = workloads[uidx].astype(np.int64)
        keys = cols[uidx]
    counts = np.bincount(inv).astype(np.int32)
    crp, cjr = keys[:, 0], keys[:, 1]
    cdemand = keys[:, 2:].reshape(len(counts), demand.shape[1],
                                  demand.shape[2])
    return inv, cw, crp, cjr, cdemand, counts


def _pow2(n: int, floor: int) -> int:
    return max(floor, 1 << max(int(n) - 1, 0).bit_length())


class PassInputs(NamedTuple):
    """What ``pass_inputs`` prepares: the pass's thirteen tensors (``args``,
    in ``ops.pack_all_types``'s order), and what turns its records back into
    task rows: the catalog index of each type position (``ks``), the class
    count before padding (``C``), the task rows grouped by class, ascending
    (``order_rows``, class c's from ``starts[c]``), and the budget the pass
    starts from (``budget0``)."""
    args: Tuple[torch.Tensor, ...]
    ks: List[int]
    C: int
    order_rows: np.ndarray
    starts: np.ndarray
    budget0: np.ndarray


def pass_inputs(demand_by_family: np.ndarray, workloads: np.ndarray,
                rp: np.ndarray, job_rp: Optional[np.ndarray], catalog: Catalog,
                pairwise: np.ndarray,
                type_mask: Optional[np.ndarray] = None,
                region_budget: Optional[np.ndarray] = None, *,
                device) -> Optional[PassInputs]:
    """The host side of ``pack_torch`` before the pass: the task classes,
    padded to power-of-two buckets as the reference pads them for its jit
    shapes, and the masked-in types in descending cost, as tensors on
    ``device`` in ``torch.get_default_dtype()``; None when there is no task
    or no type."""
    T = demand_by_family.shape[0]
    if T == 0:
        return None
    jr = rp if job_rp is None else job_rp  # single-task == jobrp ≡ rp
    dt = torch.get_default_dtype()
    if dt not in _NP_DTYPES:
        raise TypeError(f"the packer computes in float32 or float64, not {dt}")
    np_dt = _NP_DTYPES[dt]
    merge = bool(np.all(pairwise == 1.0))
    inv, cw, crp, cjr, cdemand, counts = _collapse_classes(
        np.asarray(workloads), np.asarray(rp), np.asarray(jr),
        np.asarray(demand_by_family), merge)
    C = counts.size
    order_rows = np.argsort(inv, kind="stable")  # ascending rows per class
    starts = np.concatenate([[0], np.cumsum(counts)])

    c_pad = _pow2(C, 4)
    m_cap = _pow2(int(counts.max()), 8)
    rows_pad = np.full((c_pad, m_cap), T, np.int32)
    for c in range(C):
        rows_pad[c, :counts[c]] = order_rows[starts[c]:starts[c + 1]]
    pad = c_pad - C
    counts_p = np.concatenate([counts, np.zeros(pad, np.int32)])
    cw_p = np.concatenate([cw, np.zeros(pad, np.int64)]).astype(np.int32)
    crp_p = np.concatenate([crp, np.zeros(pad)]).astype(np_dt)
    cjr_p = np.concatenate([cjr, np.zeros(pad)]).astype(np_dt)
    cdem_p = np.concatenate(
        [cdemand, np.zeros((pad,) + cdemand.shape[1:])]).astype(np_dt)

    ks = [k for k in catalog.order_desc.tolist()
          if type_mask is None or bool(np.asarray(type_mask)[k])]
    if not ks:
        return None
    costs = catalog.costs[ks].astype(np_dt)
    caps = catalog.capacities[ks].astype(np_dt)
    fams = catalog.family_ids[ks].astype(np.int32)
    if region_budget is not None:
        rids = catalog.region_ids[ks].astype(np.int32)
        budget0 = np.minimum(region_budget, _BIG_I).astype(np.int32)
    else:
        rids = np.zeros(len(ks), np.int32)
        budget0 = np.array([_BIG_I], np.int32)

    def on(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    P = torch.as_tensor(np.asarray(pairwise), dtype=dt, device=device)
    logP = torch.log(torch.clamp(P, min=1e-9))
    args = (*(on(a) for a in (cdem_p, cw_p, crp_p, cjr_p, counts_p, rows_pad)),
            P, logP, *(on(a) for a in (costs, caps, fams, rids, budget0)))
    return PassInputs(args, ks, C, order_rows, starts, budget0)


def pack_torch(demand_by_family: np.ndarray, workloads: np.ndarray,
               rp: np.ndarray, job_rp: Optional[np.ndarray], catalog: Catalog,
               pairwise: np.ndarray,
               type_mask: Optional[np.ndarray] = None,
               region_budget: Optional[np.ndarray] = None, *,
               device="cuda") -> List[Tuple[int, List[int]]]:
    """Engine entry point (same contract as the numpy/python engines,
    including in-place ``region_budget`` consumption).  ``device="cuda"``
    packs with the kernel and raises without a card; ``"cpu"`` packs with
    the plain version."""
    from .. import resolve_device
    from ..kernels import build
    from ..kernels.pack_fill import kernel as pack_kernel
    from ..kernels.pack_fill.ops import pack_all_types

    dev = resolve_device(device)
    inputs = pass_inputs(demand_by_family, workloads, rp, job_rp, catalog,
                         pairwise, type_mask, region_budget, device=dev)
    if inputs is None:
        return []
    T = demand_by_family.shape[0]
    max_fills = _pow2(max(256, T // 2 + 8), 256)
    while True:  # record count ≤ T, so doubling always terminates
        fresh = dev.type == "cuda" and pack_kernel.NAME not in build.BUILT
        # the bool(overflow) host sync sits inside the span, so the device
        # time is part of the measurement
        with _prof.span("torch_pack") as sp:
            budget_out, rec_type, rec_rep, rec_comp, n_rec, overflow = \
                pack_all_types(*inputs.args, max_fills=max_fills)
            overflowed = bool(overflow)
        if sp is not None:
            sp.tags["stage"] = ("build" if fresh and pack_kernel.NAME
                                in build.BUILT else "execute")
            sp.tags["max_fills"] = max_fills
            sp.tags["n_tasks"] = T
        if not overflowed:
            break
        max_fills *= 2

    nrec = int(n_rec)
    rt = rec_type[:nrec].cpu().numpy()
    rr = rec_rep[:nrec].cpu().numpy()
    rc = rec_comp[:nrec].cpu().numpy()
    order_rows, ptr = inputs.order_rows, inputs.starts[:-1].copy()
    out: List[Tuple[int, List[int]]] = []
    for i in range(nrec):
        k = inputs.ks[int(rt[i])]
        rep = int(rr[i])
        comp = rc[i]
        cls = np.nonzero(comp[:inputs.C])[0]
        chunks = []
        for c in cls:
            n = int(comp[c]) * rep
            chunks.append(order_rows[ptr[c]:ptr[c] + n]
                          .reshape(rep, int(comp[c])))
            ptr[c] += n
        allrows = np.concatenate(chunks, axis=1)
        for j in range(rep):
            out.append((k, allrows[j].tolist()))
    if region_budget is not None:
        consumed = inputs.budget0.astype(np.int64) - \
            budget_out.cpu().numpy().astype(np.int64)
        region_budget -= consumed  # in place: callers track remaining budget
    return out
