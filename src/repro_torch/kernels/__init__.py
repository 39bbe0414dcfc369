"""Hand-written Hopper kernels, each in the layout of ``repro/kernels``:

    csrc/*.cu  — the CUDA C++ kernel with a plain C interface (built by ``build``)
    kernel.py  — the ctypes wrapper: checks, allocates, launches, counts
    ref.py     — the plain PyTorch version the tests and the CPU use
    ops.py     — the dispatch the model calls

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper adds
one there when it launches its kernel and nowhere else.
"""
import collections

LAUNCHES: "collections.Counter[str]" = collections.Counter()
