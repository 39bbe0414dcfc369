"""The SSD kernels' share of their bound over the profiled stretch: the sum
over the SSD's forward and backward calls of each call's bound
(``counts.kernels``, the chunked SSD at the configuration's chunk) over the
sum of those kernels' device time, in %.  A forward call is one chunk-scan
launch, a backward call one backward chunk launch; the other kernels of
each count in the time.  None where no SSD kernel ran."""
from ..counts.categories import ssd_part
from ..counts.kernels import bound_s, ssd_bwd, ssd_fwd


def read(run):
    if run.trace is None:
        return None
    time_s = sum(run.trace.device_s_by(ssd_part).values())
    calls = run.trace.count_by(ssd_part)
    if not time_s:
        return None
    c, w = run.c, run.window
    d_inner = c["ssm_expand"] * c["d_model"]
    shape = (w["batch"], w["seq"], d_inner // c["ssm_headdim"],
             c["ssm_headdim"], c["ssm_groups"], c["ssm_state"],
             c["ssd_chunk"])
    bound = calls.get("fwd", 0) * bound_s(*ssd_fwd(*shape)) \
        + calls.get("bwd", 0) * bound_s(*ssd_bwd(*shape))
    return 100.0 * bound / time_s
