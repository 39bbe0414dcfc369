"""``FlightRecorder`` — the bundle threaded through simulator + scheduler.

One recorder per run holds the four observability surfaces:

* ``events``   — :class:`repro.obs.events.EventLog` (lifecycle + cost)
* ``decisions``— :class:`repro.obs.trace.DecisionTrace` (planner explain)
* ``metrics``  — :class:`repro.obs.metrics.MetricsRegistry` (time series)
* ``profiler`` — :class:`repro.obs.profiler.Profiler` (wall-clock spans)

Attach it to both ends of a run::

    rec = FlightRecorder(meta={"bench": "spot", "scheduler": "eva-spot"})
    sched = EvaScheduler(cat, policies=[...], recorder=rec)
    m = Simulator(cat, jobs, sched, cfg, recorder=rec).run()
    rec.save("results/traces/run.jsonl")

and replay it offline with ``tools/explain.py``.  The JSONL layout is one
object per line, discriminated by ``rec``: a ``meta`` header, then
``event`` / ``cost`` / ``decision`` / ``series`` / ``span`` records.
``FlightRecorder.load`` round-trips the artifact.

The recorder is a pure observer — the hard invariant of the subsystem:
with no recorder attached the hot paths are bit-identical to the seed,
and with one attached decisions are unchanged (both pinned by
``tests/test_obs.py``).
"""
from __future__ import annotations

import json
import os
from typing import Optional

from .events import EventLog
from .metrics import MetricsRegistry
from .profiler import Profiler
from .trace import DecisionRecord, DecisionTrace

FORMAT_VERSION = 1


class FlightRecorder:
    def __init__(self, meta: Optional[dict] = None):
        self.meta = dict(meta or {})
        self.events = EventLog()
        self.decisions = DecisionTrace()
        self.metrics = MetricsRegistry()
        self.profiler = Profiler()

    # -- serialization ------------------------------------------------------
    def to_jsonl(self) -> str:
        lines = [json.dumps({"rec": "meta", "version": FORMAT_VERSION,
                             **self.meta})]
        for e in self.events:
            lines.append(json.dumps({"rec": "event", **e.to_dict()}))
        for (cat, key), amt in self.events.costs.items():
            lines.append(json.dumps({"rec": "cost", "category": cat,
                                     "key": key, "amount": amt}))
        for r in self.decisions:
            lines.append(json.dumps({"rec": "decision", **r.to_dict()}))
        md = self.metrics.to_dict()
        if any(md.values()):
            lines.append(json.dumps({"rec": "series", **md}))
        for s in self.profiler.to_dicts():
            lines.append(json.dumps({"rec": "span", **s}))
        return "\n".join(lines) + "\n"

    def save(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_jsonl())
        return path

    @classmethod
    def load(cls, path: str) -> "FlightRecorder":
        rec = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                kind = d.pop("rec", None)
                if kind == "meta":
                    d.pop("version", None)
                    rec.meta = d
                elif kind == "event":
                    from .events import Event
                    ev = Event.from_dict(d)
                    # JSON round-trips tuples as lists; re-freeze id payloads
                    ev = Event(ev.t, ev.kind, ev.instance_id, ev.job_id,
                               tuple((k, tuple(v) if isinstance(v, list)
                                      else v) for k, v in ev.fields))
                    rec.events.events.append(ev)
                elif kind == "cost":
                    rec.events.record_cost(d["category"], d["key"],
                                           float(d["amount"]))
                elif kind == "decision":
                    rec.decisions.append(DecisionRecord.from_dict(d))
                elif kind == "series":
                    rec.metrics = MetricsRegistry.from_dict(d)
                elif kind == "span":
                    from .profiler import Span
                    rec.profiler.spans.append(Span(
                        d["name"], float(d["start_s"]),
                        float(d["duration_s"]), d.get("tags", {})))
        return rec
