"""Hand-written Hopper kernels, each in the layout of ``repro/kernels``:

    csrc/*.cu  — the CUDA C++ kernel with a plain C interface (built by ``build``)
    kernel.py  — the ctypes wrapper: checks, allocates, launches, counts
    ref.py     — the plain PyTorch version the tests and the CPU use
    ops.py     — the dispatch the model calls

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper adds
one there, through ``count_launch``, when it launches its kernel and nowhere
else.  The count is taken under a lock, since several threads may launch at
once (the workers of ``cluster.localcloud``).
"""
import collections
import threading

LAUNCHES: "collections.Counter[str]" = collections.Counter()
_LAUNCHES_LOCK = threading.Lock()


def count_launch(name: str) -> None:
    """Adds one to ``LAUNCHES[name]``; safe across threads."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1
