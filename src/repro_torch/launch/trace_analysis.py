"""What one rank executes in a step, counted while the step runs on a mesh
of DTensors: the port's counterpart of ``repro/launch/hlo_analysis.py``,
which parses the partitioned HLO text.  The port has no HLO; it traces.

``analyze_step(fn, *inputs)`` runs ``fn`` (a train, prefill or decode step
on DTensor inputs, usually fake ones on a fake process group) and returns
the reference's keys:

  * ``flops``              — matmul-class FLOPs, with the kernels' custom
                             ops by their own formulas (``kernels.flops``);
                             ``kernel_flops``, those of the kernels alone
  * ``collective_bytes``   — bytes of every collective's output on this
                             rank, and ``collective_by_kind`` by the
                             reference's kinds (all-gather, all-reduce,
                             reduce-scatter, all-to-all)
  * ``collective_ops``     — the collectives, as ``CommDebugMode`` counts
                             them
  * ``collective_sites``   — the collective bytes by the line of the port
                             (``models/``, ``train/``, ``kernels/``) whose
                             operation issued them; those of autograd's
                             backward, which runs no line of the port,
                             under "backward"

All quantities are PER DEVICE.  ``FlopCounterMode`` entered around a DTensor
program counts each operation once at its global shape, since a dispatch
mode sees an operation before DTensor splits it into the local one.  So the
count here is taken by a dispatch mode that steps aside for DTensor
arguments (it returns NotImplemented, and DTensor runs the operation), and
counts the plain operations DTensor then runs on this rank's shards, with
``FlopCounterMode``'s formulas (``torch.utils.flop_counter.flop_registry``).
DTensor also runs each new operation once on fake tensors of the global
shapes, to learn its output's shape (``ShardingPropagator.
_propagate_tensor_meta*``); those runs are not the rank's work and are
skipped.
Work that every rank repeats, such as a replicated CE head or a
rematerialised layer, is counted on each rank, as the reference's per-device
HLO counts it.  A collective moves the tensors of its local operation, so
its output bytes are what this rank receives, as the reference counts an
HLO collective's output shape.
"""
from __future__ import annotations

import collections
import sys
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# the functional collectives DTensor issues, by the reference's kinds
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _site() -> str:
    """The innermost line of the port's model, training or kernel code on
    the stack, as ``file.py:line``; "backward" for none (autograd's engine
    runs a backward operation with no such line on the stack)."""
    frame = sys._getframe(2)
    while frame is not None:
        path = frame.f_code.co_filename.replace("\\", "/")
        if "/repro_torch/" in path and "/launch/" not in path \
                and not path.endswith("/sharding.py") \
                and not path.endswith("/shards.py"):
            return f"{path.rsplit('/', 1)[-1]}:{frame.f_lineno}"
        frame = frame.f_back
    return "backward"


def _in_shape_propagation() -> bool:
    """Whether DTensor is running an operation at its global shapes to learn
    its output's metadata."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        frame = frame.f_back
    return False


class _RankCounter(TorchDispatchMode):
    """Counts the FLOPs and the collective bytes of the plain (local)
    operations of one rank."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.kernel_flops = 0
        self.coll = collections.Counter()
        self.sites = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor run it on the shards
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        kind = _KINDS.get(packet.__name__)
        if (packet not in self.registry and kind is None) \
                or _in_shape_propagation():
            return out
        if packet in self.registry:
            n = int(self.registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            if func.namespace == "repro_torch":
                self.kernel_flops += n
        if kind is not None and "_c10d_functional" in str(packet):
            leaves, _ = tree_flatten(out)
            n = sum(t.numel() * t.element_size() for t in leaves
                    if isinstance(t, torch.Tensor))
            self.coll[kind] += n
            self.sites[_site()] += n
        return out


def analyze_step(fn: Callable, *inputs) -> Dict[str, object]:
    """Runs ``fn(*inputs)`` once and counts what this rank executed."""
    from torch.distributed.tensor.debug import CommDebugMode
    comm = CommDebugMode()
    counter = _RankCounter()
    with comm, counter:
        fn(*inputs)
    return {"flops": float(counter.flops),
            "kernel_flops": float(counter.kernel_flops),
            "collective_bytes": int(sum(counter.coll.values())),
            "collective_by_kind": {k: int(v) for k, v in counter.coll.items()
                                   if v},
            "collective_ops": int(comm.get_total_counts()),
            "collective_sites": dict(counter.sites.most_common())}
