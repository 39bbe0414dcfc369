"""Device ms a step or batch, in the profiled stretch, of every device
operation that is neither a hand-written kernel nor a matrix product:
PyTorch's elementwise passes, reductions, indexing, copies and sets."""
from ..counts.categories import OTHER, category


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    s = run.trace.device_s_by(lambda n: "x" if category(n) == OTHER else None)
    return 1e3 * s.get("x", 0.0) / run.trace.units
