"""Logical-axis sharding (``repro/models/sharding.py``) on DTensor:
parameters and activations carry logical axis names; resolution against the
active mesh picks the first candidate whose size divides the dimension (so
e.g. a 51,865-entry vocab falls back to feature-dim sharding instead of
failing on a 16-way model axis).

Param FSDP dim ("embed") shards on `data`; tensor dims ("vocab", "heads",
"ffn", "experts", "inner") shard on `model`; everything is replicated over
`pod` (pure cross-pod DP).  Activations: "batch" -> (pod, data), tensor dims
-> model.

The rule tables and their resolution are the reference's, verbatim.  A spec
is ``P``, a tuple whose entries are None, a mesh axis name, or a tuple of
names, as ``jax.sharding.PartitionSpec`` holds them.  A mesh is ``Mesh``: a
``torch.distributed.DeviceMesh`` with named dimensions, whose ``shape`` maps
each name to its size as ``jax.sharding.Mesh.shape`` does.  ``placements``
turns a spec into DTensor placements; ``constrain`` redistributes an
activation to them under a mesh and returns its input outside one.
"""
from __future__ import annotations

import collections
import contextlib
import threading
from typing import Optional, Sequence

import torch

# candidate mesh axes per logical axis, in priority order; entries may be
# tuples (sharded over several mesh axes jointly).
PARAM_RULES = {
    "batch": [("pod", "data"), "data"],  # caches / batched state
    "vocab": ["model"],
    "embed": ["data"],
    "embed+": ["data", "model"],  # embedding feature dim (vocab fallback)
    "heads": ["model"],
    "kv_heads": ["model"],
    "ffn": ["model"],
    "experts": ["model"],
    "inner": ["model"],
    "head_dim": [],
    "conv": [],
    None: [],
}

ACT_RULES = {
    "batch": [("pod", "data"), "data"],
    "heads": ["model"],
    "kv_heads": ["model"],
    "ffn": ["model"],
    "experts": ["model"],
    "inner": ["model"],
    "embed": [],
    "seq": [],
    "qseq": ["model"],  # context-parallel attention (unshardable heads)
    "vocab": ["model"],
    None: [],
}

# --- sharding profiles (perf iterations, see EXPERIMENTS.md §Perf) ---------
# "fsdp": no tensor parallelism — batch and parameters shard across the
# combined (data, model) axes; collectives become overlappable weight
# all-gathers + gradient reduce-scatters instead of per-layer activation
# all-reduces.  Best for big dense training at batch >= n_chips.
_FSDP_PARAM_RULES = {
    "batch": [("pod", "data", "model"), ("data", "model"), "data"],
    "vocab": [("data", "model"), "data", "model"],
    "embed": [("data", "model"), "data"],
    "embed+": [("data", "model"), "data", "model"],
    "heads": [],
    "kv_heads": [],
    "ffn": [("data", "model"), "data"],
    "experts": [("data", "model"), "data", "model"],
    "inner": [("data", "model"), "data"],
    "head_dim": [], "conv": [], None: [],
}
_FSDP_ACT_RULES = {
    "batch": [("pod", "data", "model"), ("data", "model"), "data"],
    "heads": [], "kv_heads": [], "ffn": [], "experts": [], "inner": [],
    "embed": [], "seq": [], "qseq": [], "vocab": [], None: [],
}
# "inference-tp": weights live model-sharded and data-replicated — zero
# per-step weight all-gathers (decode is bandwidth-bound; FSDP gathers
# dominate otherwise).
_INF_PARAM_RULES = dict(PARAM_RULES, embed=[], inner=["model"])

PROFILES = {
    "2d": (PARAM_RULES, ACT_RULES),
    "fsdp": (_FSDP_PARAM_RULES, _FSDP_ACT_RULES),
    "inference-tp": (_INF_PARAM_RULES, ACT_RULES),
}


class P(tuple):
    """A partition spec: one entry per tensor dimension, None (replicated),
    a mesh axis name, or a tuple of names (sharded over them jointly, the
    first name outermost), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """A ``DeviceMesh`` with named dimensions.  ``shape`` maps each name to
    its size, in the mesh's order, as ``jax.sharding.Mesh.shape`` does, so
    the rule resolution reads it as the reference reads a JAX mesh."""

    def __init__(self, device_mesh):
        if not device_mesh.mesh_dim_names:
            raise ValueError("the mesh needs named dimensions (mesh_dim_names)")
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = collections.OrderedDict(
            zip(self.axis_names, device_mesh.shape))

    @property
    def size(self) -> int:
        return self.device_mesh.size()

    def __repr__(self) -> str:
        return f"Mesh({dict(self.shape)}, {self.device_mesh.device_type!r})"


class _Ctx(threading.local):
    mesh: Optional[Mesh] = None
    profile: str = "2d"


_ctx = _Ctx()


@contextlib.contextmanager
def mesh_context(mesh: Optional[Mesh], profile: str = "2d"):
    """Under a mesh, ``constrain`` places activations, and a plain tensor
    that an operation meets beside a DTensor (a position ``arange``, a mask,
    a zero buffer) counts as replicated over the mesh, as GSPMD treats a
    constant (``implicit_replication``)."""
    prev = (_ctx.mesh, getattr(_ctx, "profile", "2d"))
    _ctx.mesh = mesh
    _ctx.profile = profile
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
    finally:
        _ctx.mesh, _ctx.profile = prev


def remat(fn, *args):
    """``torch.utils.checkpoint`` of ``fn(*args)`` (non-reentrant), its
    recompute in the backward under the mesh context of the forward: the
    backward of a CUDA tensor runs on autograd's own thread, where this
    module's thread-local context is empty."""
    import torch.utils.checkpoint as cp
    mesh, profile = _ctx.mesh, getattr(_ctx, "profile", "2d")
    if mesh is None:
        return cp.checkpoint(fn, *args, use_reentrant=False)
    return cp.checkpoint(fn, *args, use_reentrant=False, context_fn=lambda: (
        contextlib.nullcontext(), mesh_context(mesh, profile)))


def current_mesh() -> Optional[Mesh]:
    return _ctx.mesh


def current_profile() -> str:
    return getattr(_ctx, "profile", "2d")


def _axis_size(mesh: Mesh, cand) -> int:
    names = (cand,) if isinstance(cand, str) else tuple(cand)
    size = 1
    for n in names:
        if n not in mesh.shape:
            return 0  # axis not present in this mesh
        size *= mesh.shape[n]
    return size


def _resolve_dim(dim: int, logical, mesh: Mesh, taken: set, rules) -> Optional[tuple]:
    for cand in rules.get(logical, []):
        names = (cand,) if isinstance(cand, str) else tuple(cand)
        if any(n in taken for n in names):
            continue
        size = _axis_size(mesh, cand)
        if size <= 1 or dim % size != 0:
            continue
        taken.update(names)
        return names
    return None


def spec_for(shape: Sequence[int], axes: Sequence, mesh: Mesh,
             rules=PARAM_RULES) -> P:
    assert len(shape) == len(axes), (shape, axes)
    taken: set = set()
    out = []
    for dim, ax in zip(shape, axes):
        names = _resolve_dim(int(dim), ax, mesh, taken, rules)
        if names is None:
            out.append(None)
        elif len(names) == 1:
            out.append(names[0])
        else:
            out.append(names)
    return P(*out)


def placements(spec: Sequence, mesh: Mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dimension,
    ``Shard(d)`` of the tensor dimension d that names it, else
    ``Replicate()``.  A tensor dimension sharded over several axes jointly,
    ("pod", "data") say, is split first over the first name, and each part
    again over the next: a device's block is the one JAX's ``PartitionSpec``
    gives it, since DTensor splits a dimension sharded on several mesh
    dimensions in mesh order and every rule table names joint axes in the
    mesh's own order."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.axis_names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        where = [mesh.axis_names.index(n) for n in names]
        if where != sorted(where):
            raise ValueError(f"spec entry {entry} does not follow the mesh's "
                             f"axis order {mesh.axis_names}")
        for i in where:
            out[i] = Shard(d)
    return tuple(out)


def placements_for(shape, axes, mesh: Mesh, rules=PARAM_RULES) -> tuple:
    """The DTensor placements of a tensor of ``shape`` whose dimensions
    carry the logical ``axes`` (the reference's ``named_sharding``)."""
    return placements(spec_for(shape, axes, mesh, rules), mesh)


def distribute(t: torch.Tensor, mesh: Mesh, spec: Sequence, device=None):
    """The DTensor placed by ``spec`` whose global value is ``t``, a tensor
    every rank holds whole and alike (a seeded init, a deterministic batch,
    an array read from a checkpoint): each rank keeps its own block, the
    ``chunk`` of each sharded dimension at its mesh coordinate, in mesh
    order, with no communication.  With ``device`` only the block is copied
    there, so a host tensor's other blocks never reach this rank's device.
    On a 1 x 1 mesh without a device the shard is ``t`` itself."""
    from torch.distributed.tensor import DTensor, Shard
    dm = mesh.device_mesh
    place = placements(spec, mesh)
    coord = dm.get_coordinate()
    local = t.detach()
    for i, p in enumerate(place):
        if isinstance(p, Shard):
            local = local.chunk(dm.size(i), dim=p.dim)[coord[i]]
    if device is not None:
        local = local.to(device, copy=True)
    return DTensor.from_local(local.contiguous(), dm, place, run_check=False,
                              shape=t.shape, stride=t.stride())


def place_flat(items, mesh: Optional[Mesh], specs: dict, device=None) -> dict:
    """{flat key: tensor} of ``(flat key, tensor)`` pairs, taken one at a
    time: a key that ``specs`` (flat key -> spec) covers as ``distribute``
    places it on ``mesh``, every other key a plain tensor on ``device``
    (where it is, without one).  A checkpoint's restore and the train
    launcher's fresh state are both placed by it."""
    out = {}
    for k, t in items:
        if k in specs:
            out[k] = distribute(t, mesh, specs[k], device)
        else:
            out[k] = t if device is None else t.to(device)
    return out


def einsum(eq: str, a, b):
    """``torch.einsum(eq, a, b)``; on DTensors, each rank's product of its
    shards, placed by one rule rather than by a PyTorch version's choice of
    strategy: on each mesh axis the first operand's sharded output letter
    stays sharded (else the second's; the other operand is gathered there
    unless it shards the same letter), a contracted letter sharded on the
    same axis in both operands gives a partial sum, and every other sharded
    dimension is gathered first."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not (isinstance(a, DTensor) or isinstance(b, DTensor)):
        return torch.einsum(eq, a, b)
    from ..kernels.shards import dense_grad
    ins, out = eq.replace(" ", "").split("->")
    letters = ins.split(",")
    mesh = (a if isinstance(a, DTensor) else b).device_mesh
    ops = [t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False) for t in (a, b)]

    def sharded(t, ls, i):
        p = t.placements[i]
        return ls[p.dim] if isinstance(p, Shard) else None

    place, grad, where = ([], []), ([], []), []
    for i in range(mesh.ndim):
        la, lb = (sharded(t, ls, i) for t, ls in zip(ops, letters))
        keep = next((c for c in (la, lb) if c is not None and c in out), None)
        if keep is None and la is not None and la == lb:
            keep = la  # contracted on both sides: a partial sum
        for j, ls in enumerate(letters):
            if keep is not None and keep in ls:
                place[j].append(Shard(ls.index(keep)))
                grad[j].append(Shard(ls.index(keep)))
            else:
                place[j].append(Replicate())
                grad[j].append(Partial() if keep is not None else Replicate())
        where.append(Replicate() if keep is None else
                     Shard(out.index(keep)) if keep in out else Partial())
    local = [dense_grad(t.redistribute(mesh, p).to_local(grad_placements=g),
                        mesh) for t, p, g in zip(ops, place, grad)]
    o = torch.einsum(eq, *local)
    return DTensor.from_local(o.contiguous() if mesh.size() > 1 else o, mesh,
                              where, run_check=False)


def matmul(a, b):
    """``a @ b`` (``torch.bmm`` for two 3-d operands): an activation times a
    (d, f) weight, or the experts' batched (e, n, d) @ (e, d, f); on
    DTensors, the same product by ``einsum``'s rule."""
    from torch.distributed.tensor import DTensor
    if not (isinstance(a, DTensor) or isinstance(b, DTensor)):
        return torch.bmm(a, b) if a.dim() == b.dim() == 3 else a @ b
    if b.dim() == 3:
        return einsum("enk,ekf->enf", a, b)
    lead = "abcdeghij"[:a.dim() - 1]
    return einsum(f"{lead}k,kf->{lead}f", a, b)


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """Activation sharding constraint (no-op outside a mesh context): under
    a mesh, ``x`` (a DTensor) is redistributed to the placements its logical
    axes resolve to."""
    mesh = _ctx.mesh
    if mesh is None:
        return x
    spec = spec_for(x.shape, axes, mesh, rules=ACT_RULES)
    return x.redistribute(mesh.device_mesh, placements(spec, mesh))
