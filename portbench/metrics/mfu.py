"""The window's model FLOPs (the frozen ``model_flops`` at the cell's shape,
train or prefill, times the steps or batches completed) over the window's
seconds times the card's bf16 peak, in %."""
from ..counts.flops import model_flops
from ..counts.peaks import PEAK_FLOPS


def read(run):
    w = run.window
    flops = model_flops(run.c, run.n_params, w["kind"], w["batch"], w["seq"])
    return 100.0 * flops * w["units"] / (w["seconds"] * PEAK_FLOPS)
