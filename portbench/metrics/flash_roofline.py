"""The flash-attention kernels' share of their bound over the profiled
stretch: the sum over its forward and backward calls of each call's bound
(``counts.kernels``, at the cell's shape: causal, the configuration's heads)
over the sum of those kernels' device time, in %.  A forward call is one
forward launch; a backward call is one dK/dV launch, with the backward's
other kernels' time counted.  None where no flash kernel ran."""
from ..counts.categories import flash_part
from ..counts.kernels import bound_s, flash_bwd, flash_fwd


def read(run):
    if run.trace is None:
        return None
    time_s = sum(run.trace.device_s_by(flash_part).values())
    calls = run.trace.count_by(flash_part)
    if not time_s:
        return None
    c, w = run.c, run.window
    hd = c.get("head_dim") or c["d_model"] // c["n_heads"]
    shape = (w["batch"], w["seq"], c["n_heads"], c["n_kv_heads"], hd)
    training = w["kind"] == "train"
    bound = calls.get("fwd", 0) * bound_s(*flash_fwd(*shape, lse=training)) \
        + calls.get("bwd", 0) * bound_s(*flash_bwd(*shape))
    return 100.0 * bound / time_s
