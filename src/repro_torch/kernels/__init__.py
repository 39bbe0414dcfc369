"""Hand-written Hopper kernels, each in the layout of ``repro/kernels``:

    csrc/*.cu  — the CUDA C++ kernel with a plain C interface (built by ``build``)
    kernel.py  — the ctypes wrapper: checks, allocates, launches, counts
    ref.py     — the plain PyTorch version the tests and the CPU use
    ops.py     — the dispatch the model calls

Each kernel's launch is registered as a custom op
(``torch.library.custom_op``, ``repro_torch::<name>``) whose fake
implementation gives shapes alone and whose flop formula (``flops.py``)
counts its work, so that a step on fake tensors traces through it
(``launch.dryrun``); ``run`` takes the op for a fake tensor and calls the
launch itself for a real one, without the dispatcher's host time.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper adds
one there, through ``count_launch``, when it launches its kernel and nowhere
else.  The count is taken under a lock, since several threads may launch at
once (the workers of ``cluster.localcloud``).
"""
import collections
import threading

LAUNCHES: "collections.Counter[str]" = collections.Counter()
_LAUNCHES_LOCK = threading.Lock()


def run(op, launch, *args):
    """``op(*args)`` when the first tensor among ``args`` is a fake tensor
    (a trace, which the op's fake implementation answers), else
    ``launch(*args)``, the function the op registers: the dispatcher's tens
    of microseconds a call would show beside kernels that take as few."""
    from torch._subclasses.fake_tensor import FakeTensor
    first = next(a for a in args if hasattr(a, "shape"))
    return (op if isinstance(first, FakeTensor) else launch)(*args)


def count_launch(name: str) -> None:
    """Adds one to ``LAUNCHES[name]``; safe across threads."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1
