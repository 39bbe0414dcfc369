"""Structured run reporter: greppable ``key=value`` lines + JSON verdicts.

Replaces the ad-hoc ``print`` reporting in ``benchmarks/run.py`` and
``tools/bench_compare.py``.  Each ``emit`` prints one line

    [scope] event key=value key=value ...

(values with whitespace are quoted) and appends the record to an
in-memory list, so a CI step can both grep the log and write the whole
run as machine-readable JSON (``--json``) — e.g. the perf gate's
per-cell verdicts.
"""
from __future__ import annotations

import json
import sys
from typing import List, Optional, TextIO


def _fmt(v) -> str:
    if isinstance(v, float):
        s = f"{v:.6g}"
    elif isinstance(v, bool):
        s = "true" if v else "false"
    else:
        s = str(v)
    if any(c.isspace() for c in s) or s == "":
        return json.dumps(s)
    return s


class Reporter:
    def __init__(self, scope: str, stream: Optional[TextIO] = None):
        self.scope = scope
        self.stream = stream if stream is not None else sys.stdout
        self.records: List[dict] = []

    def emit(self, event: str, **kv) -> dict:
        rec = {"event": event, **kv}
        self.records.append(rec)
        line = " ".join([f"[{self.scope}]", event]
                        + [f"{k}={_fmt(v)}" for k, v in kv.items()])
        print(line, file=self.stream)
        return rec

    def of(self, event: str) -> List[dict]:
        return [r for r in self.records if r["event"] == event]

    def write_json(self, path: str, **extra) -> None:
        out = {"scope": self.scope, **extra, "records": self.records}
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
