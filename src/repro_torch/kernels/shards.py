"""The kernels under a mesh: each entry point (``ops.flash_attention``,
``ops.ssd``, ``ops.rglru_scan``) given DTensors runs on every rank's local
shards and wraps its outputs back as DTensors, since a kernel has no
sharding rule of its own.

Only the batch and the heads (or channels) may stay sharded: each is a
dimension a kernel computes independently along, so a shard is a complete
kernel input.  Every other dimension is gathered first.  The lead tensor
(q, x, a) decides, mesh dimension by mesh dimension, which of the two is
sharded; the other inputs follow it.  A grouped input (k and v under
grouped-query attention, the SSD's B and C) whose groups do not divide over
a mesh dimension that shards the heads stays replicated there, and each
rank slices out the groups its heads read; its gradient is then a partial
sum over that mesh dimension, as is the gradient of an input that every
shard of the lead reads whole (the SSD's A and D over the batch).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


class Arg:
    """An input: the tensor (or None), the dimension index of each role it
    has (``{"batch": 0, "heads": 2}``), and for a grouped input its number
    of groups over the lead's number of heads."""

    def __init__(self, value, dims: dict, groups: Optional[tuple] = None):
        self.value, self.dims, self.groups = value, dims, groups


def on_shards(fn: Callable, lead, lead_dims: dict, args: Sequence[Arg],
              out_dims: Sequence[dict]):
    """``fn`` on the local shards of ``args``; its outputs (a tensor or a
    tuple) as DTensors whose dimensions of role r are sharded where the
    lead's are.  ``lead`` is a DTensor among ``args``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = lead.device_mesh
    roles = []  # for each mesh dimension, the role sharded over it
    for p in lead.placements:
        role = None
        if isinstance(p, Shard):
            role = next((r for r, d in lead_dims.items() if d == p.dim), None)
        roles.append(role)

    local = []
    for arg in args:
        t = arg.value
        if t is None:
            local.append(None)
            continue
        place, grad, cut = [], [], None
        for i, role in enumerate(roles):
            if role is None:  # every rank computes the same
                place.append(Replicate())
                grad.append(Replicate())
            elif role not in arg.dims:  # read by every shard of the lead
                place.append(Replicate())
                grad.append(Partial())
            elif role == "heads" and arg.groups \
                    and arg.groups[0] % mesh.size(i):
                place.append(Replicate())
                grad.append(Partial())
                cut = i
            else:
                place.append(Shard(arg.dims[role]))
                grad.append(Shard(arg.dims[role]))
        if not isinstance(t, DTensor):  # made inline: the same on every rank
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        t = dense_grad(t.redistribute(mesh, place).to_local(
            grad_placements=grad), mesh)
        if mesh.size() > 1:  # the kernels take contiguous shards
            t = t.contiguous()
        if cut is not None:
            t = _own_groups(t, arg, mesh, cut)
        local.append(t)

    outs = fn(*local)
    single = not isinstance(outs, tuple)
    wrapped = []
    for o, dims in zip((outs,) if single else outs, out_dims):
        place = [Shard(dims[r]) if r in dims else Replicate() for r in roles]
        # contiguous: DTensor derives the global strides from the shard's,
        # and later views of the global tensor must hold for the shard
        wrapped.append(DTensor.from_local(
            o.contiguous() if mesh.size() > 1 else o, mesh, place,
            run_check=False))
    return wrapped[0] if single else tuple(wrapped)


class _DenseGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: DTensor gives a
    shard's gradient the strides of the global tensor of the forward, so
    they must be the shard's own, or a later view of it fails (the kernels'
    gradients are contiguous already; the plain versions' may not be).  Not
    taken on a mesh of one device, whose shards are the tensors, so that it
    computes what the run without a mesh computes, to the bit."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def dense_grad(t, mesh):
    """``t``, whose gradient is made contiguous on a mesh of more than one
    device (``_DenseGrad``)."""
    if t.requires_grad and mesh.size() > 1:
        return _DenseGrad.apply(t)
    return t


def _own_groups(t, arg: Arg, mesh, i: int):
    """The groups that this rank's heads read: the heads are split evenly
    over mesh dimension ``i``, head h reads group h // (heads / groups)."""
    groups, heads = arg.groups
    m = mesh.size(i)
    if heads % m:
        raise ValueError(f"{heads} heads do not split over {m} ranks")
    per_rank, per_group = heads // m, heads // groups
    c = mesh.get_local_rank(i)
    lo = c * per_rank // per_group
    hi = ((c + 1) * per_rank - 1) // per_group + 1
    if per_rank % (hi - lo):
        raise ValueError(f"{per_rank} heads a rank cannot read {hi - lo} of "
                         f"{groups} groups evenly")
    return t.narrow(arg.dims["heads"], lo, hi - lo).contiguous()
