"""Counter / gauge / histogram time-series registry with ring buffers.

``MetricsRegistry`` is the flight recorder's numeric surface: named
counters (monotone totals), gauges sampled into bounded ring buffers
(cost burn rate per region, queue depth, SLO risk, credit balances), and
fixed-bucket histograms.  Everything serializes to the JSONL artifact and
to Prometheus text exposition format (``prom_text``), so a run can be
scraped or diffed with standard tooling.

Ring buffers keep the artifact bounded on long runs: each gauge retains
the most recent ``maxlen`` (default 4096) samples; ``dropped`` counts
what scrolled off, so downsampling is explicit, never silent.
"""
from __future__ import annotations

import bisect
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (0.001, 0.01, 0.1, 1.0, 10.0, 100.0, float("inf"))


class Series:
    """One gauge's (t, value) ring buffer."""

    def __init__(self, maxlen: int = 4096):
        self.samples: Deque[Tuple[float, float]] = deque(maxlen=maxlen)
        self.dropped = 0

    def add(self, t: float, value: float) -> None:
        if len(self.samples) == self.samples.maxlen:
            self.dropped += 1
        self.samples.append((t, float(value)))

    @property
    def last(self) -> Optional[Tuple[float, float]]:
        return self.samples[-1] if self.samples else None

    def values(self) -> List[float]:
        return [v for _, v in self.samples]


class Histogram:
    """Fixed cumulative buckets (Prometheus convention: le upper bounds)."""

    def __init__(self, buckets: Sequence[float] = _DEFAULT_BUCKETS):
        self.bounds = tuple(sorted(buckets))
        self.counts = [0] * len(self.bounds)
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        self.total += 1
        self.sum += value
        i = bisect.bisect_left(self.bounds, value)
        if i < len(self.counts):
            self.counts[i] += 1

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out


class MetricsRegistry:
    def __init__(self, maxlen: int = 4096):
        self.maxlen = maxlen
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, Series] = {}
        self.histograms: Dict[str, Histogram] = {}

    # -- emission -----------------------------------------------------------
    def inc(self, name: str, amount: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + amount

    def sample(self, name: str, t: float, value: float) -> None:
        s = self.gauges.get(name)
        if s is None:
            s = self.gauges[name] = Series(self.maxlen)
        s.add(t, value)

    def observe(self, name: str, value: float,
                buckets: Sequence[float] = _DEFAULT_BUCKETS) -> None:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(buckets)
        h.observe(value)

    # -- export -------------------------------------------------------------
    @staticmethod
    def _prom_name(name: str) -> str:
        """metric{label="x"} spelling for dotted/slashed series names."""
        if ":" in name:
            base, label = name.split(":", 1)
            base = base.replace(".", "_").replace("-", "_").replace("/", "_")
            return f'{base}{{key="{label}"}}'
        return name.replace(".", "_").replace("-", "_").replace("/", "_")

    def prom_text(self) -> str:
        """Prometheus text exposition of counters, last gauge samples and
        histograms (one scrape = the run's final state)."""
        lines: List[str] = []
        for name in sorted(self.counters):
            pn = self._prom_name(name)
            lines.append(f"# TYPE {pn.split('{', 1)[0]} counter")
            lines.append(f"{pn} {self.counters[name]:g}")
        for name in sorted(self.gauges):
            last = self.gauges[name].last
            if last is None:
                continue
            pn = self._prom_name(name)
            lines.append(f"# TYPE {pn.split('{', 1)[0]} gauge")
            lines.append(f"{pn} {last[1]:g}")
        for name in sorted(self.histograms):
            h = self.histograms[name]
            base = self._prom_name(name).split("{", 1)[0]
            lines.append(f"# TYPE {base} histogram")
            for bound, acc in zip(h.bounds, h.cumulative()):
                le = "+Inf" if bound == float("inf") else f"{bound:g}"
                lines.append(f'{base}_bucket{{le="{le}"}} {acc}')
            lines.append(f"{base}_sum {h.sum:g}")
            lines.append(f"{base}_count {h.total}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_dict(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": {n: {"samples": list(s.samples), "dropped": s.dropped}
                       for n, s in self.gauges.items()},
            "histograms": {n: {"bounds": ["inf" if b == float("inf") else b
                                          for b in h.bounds],
                               "counts": h.counts, "sum": h.sum,
                               "total": h.total}
                           for n, h in self.histograms.items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MetricsRegistry":
        reg = cls()
        reg.counters = {k: float(v) for k, v in d.get("counters", {}).items()}
        for n, sd in d.get("gauges", {}).items():
            s = reg.gauges[n] = Series(reg.maxlen)
            for t, v in sd["samples"]:
                s.samples.append((float(t), float(v)))
            s.dropped = int(sd.get("dropped", 0))
        for n, hd in d.get("histograms", {}).items():
            bounds = tuple(float("inf") if b == "inf" else float(b)
                           for b in hd["bounds"])
            h = reg.histograms[n] = Histogram(bounds)
            h.counts = [int(c) for c in hd["counts"]]
            h.sum = float(hd["sum"])
            h.total = int(hd["total"])
        return reg
