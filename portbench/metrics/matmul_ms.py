"""Device ms a step or batch, in the profiled stretch, of the kernels whose
names mark them as matrix products (cuBLAS, CUTLASS)."""
from ..counts.categories import is_matmul


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    s = run.trace.device_s_by(lambda n: "mm" if is_matmul(n) else None)
    return 1e3 * s.get("mm", 0.0) / run.trace.units
