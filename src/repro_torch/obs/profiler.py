"""Wall-clock span profiler with an inert module-level hook.

``Profiler`` records named spans (start, duration, tags) — plan rounds,
jit warmup vs steady-state execution, simulator sweeps.  Hot paths that
cannot thread a recorder argument (``core/engine_jax.py``) call the
module-level ``span`` context manager, which is a shared ``nullcontext``
unless a profiler has been activated with ``activate`` — one attribute
read and one ``is None`` branch when off, so profiling-disabled runs pay
nothing measurable.

Spans nest; each records its wall-clock duration via
``time.perf_counter``.  The profiler is wall-clock-only by design: it
never touches sim time, RNG or decisions.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Iterator, List, Optional


@dataclasses.dataclass
class Span:
    name: str
    start_s: float           # perf_counter-relative to profiler creation
    duration_s: float = 0.0
    tags: Dict[str, object] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = {"name": self.name, "start_s": round(self.start_s, 6),
             "duration_s": round(self.duration_s, 6)}
        if self.tags:
            d["tags"] = self.tags
        return d


class Profiler:
    def __init__(self) -> None:
        self._t0 = time.perf_counter()
        self.spans: List[Span] = []

    @contextlib.contextmanager
    def span(self, name: str, **tags) -> Iterator[Span]:
        s = Span(name, time.perf_counter() - self._t0, tags=dict(tags))
        t0 = time.perf_counter()
        try:
            yield s
        finally:
            s.duration_s = time.perf_counter() - t0
            self.spans.append(s)

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.duration_s
        return out

    def by_name(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]

    def to_dicts(self) -> List[dict]:
        return [s.to_dict() for s in self.spans]


# --- module-level hook for hot paths that can't thread a profiler ----------
_ACTIVE: Optional[Profiler] = None
_NULL = contextlib.nullcontext()


def activate(profiler: Optional[Profiler]) -> None:
    """Install (or, with ``None``, remove) the process-global profiler."""
    global _ACTIVE
    _ACTIVE = profiler


def active() -> Optional[Profiler]:
    return _ACTIVE


def span(name: str, **tags):
    """Span on the active profiler; a shared no-op context when inactive."""
    if _ACTIVE is None:
        return _NULL
    return _ACTIVE.span(name, **tags)
