"""The device trace of a profiled stretch of a run: ``torch.profiler``
(CPU and CUDA activities) around it, its Chrome trace written to the
run's temporary directory and read back, then deleted.

``Trace`` holds the device operations (kernels, copies, sets) inside the
stretch, the host's operations and the stretch's wall time, and gives the
busy time (the union of the operations' intervals), the idle gaps labelled
by what the host was doing, and the breakdown the result line carries."""
from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "portbench.profiled"
NAME_CHARS = 160


class Trace:
    def __init__(self, events: list, units: int):
        span = next(e for e in events if e.get("name") == SPAN
                    and e.get("ph") == "X")
        self.t0, self.t1 = float(span["ts"]), float(span["ts"]) + float(span["dur"])
        self.units = units  # steps or batches profiled
        self.device = []  # (name, start_us, end_us), clipped to the stretch
        self.host = []  # (start_us, end_us, name)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            s, d = float(e["ts"]), float(e["dur"])
            if e.get("cat") in DEVICE_CATS:
                s, t = max(s, self.t0), min(s + d, self.t1)
                if t > s:
                    self.device.append((e["name"], s, t))
            elif e.get("cat") in ("cpu_op", "user_annotation") \
                    and e["name"] != SPAN:
                self.host.append((s, s + d, e["name"]))
        self.device.sort(key=lambda x: x[1])
        self.host.sort()
        self._host_starts = [h[0] for h in self.host]

    @property
    def wall_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list:
        merged = []
        for _, s, t in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return merged

    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals()) / 1e6

    def device_s_by(self, key) -> dict:
        """Device seconds summed by ``key(name)`` (None keys dropped)."""
        out = collections.Counter()
        for name, s, t in self.device:
            k = key(name)
            if k is not None:
                out[k] += (t - s) / 1e6
        return out

    def count_by(self, key) -> dict:
        out = collections.Counter()
        for name, _, _ in self.device:
            k = key(name)
            if k is not None:
                out[k] += 1
        return out

    def idle_gaps(self) -> list:
        """(start_us, end_us) of each stretch with no device operation."""
        gaps, at = [], self.t0
        for s, t in self.busy_intervals():
            if s > at:
                gaps.append((at, s))
            at = max(at, t)
        if self.t1 > at:
            gaps.append((at, self.t1))
        return gaps

    def host_at(self, when: float) -> str:
        """The innermost host operation running at ``when``: the latest
        started one that has not ended."""
        i = bisect.bisect_right(self._host_starts, when) - 1
        for j in range(i, max(-1, i - 5000), -1):
            s, t, name = self.host[j]
            if t >= when:
                return name
        return "(no host operation)"

    def breakdown(self) -> dict:
        ops = self.device_s_by(lambda n: n[:NAME_CHARS])
        gaps = collections.Counter()
        for s, t in self.idle_gaps():
            gaps[self.host_at((s + t) / 2)[:NAME_CHARS]] += (t - s) / 1e6
        return {"device_ops": [[n, v] for n, v in ops.most_common(10)],
                "idle_gaps": [[n, v] for n, v in gaps.most_common(10)]}


def profile(unit, units: int) -> Trace:
    """Runs ``unit()`` once under the profiler to warm it (the tracer's
    first costs land there, outside the stretch), then ``units`` times in
    the stretch, and returns the stretch's trace."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        unit()
        if cuda:
            torch.cuda.synchronize()
        with record_function(SPAN):
            for _ in range(units):
                unit()
            if cuda:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return Trace(events, units)
