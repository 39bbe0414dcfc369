"""1 - (the device's busy time a step or batch: the union of the device
operations' intervals in the profiled stretch, over its steps) / (the
measured window's wall time a step or batch), in %.  The window runs
without the profiler, whose host cost would lengthen the stretch's own
wall time and read as idle device."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    busy = run.trace.busy_s() / run.trace.units
    wall = run.window["seconds"] / run.window["units"]
    return 100.0 * (1.0 - busy / wall)
