# Flight recorder: structured decision telemetry, timeline event log and
# per-layer cost attribution across planner, policy stack and simulator.
# Pure observer by contract — recording off is bit-identical, recording on
# is decision-identical (tests/test_obs.py pins both).
from . import events, profiler
from .events import (COST_COMMITMENT, COST_EGRESS, COST_INSTANCE, Event,
                     EventLog)
from .metrics import Histogram, MetricsRegistry, Series
from .profiler import Profiler, Span
from .recorder import FlightRecorder
from .report import Reporter
from .trace import DecisionRecord, DecisionTrace, KeepEntry

__all__ = [
    "events", "profiler",
    "COST_COMMITMENT", "COST_EGRESS", "COST_INSTANCE", "Event", "EventLog",
    "Histogram", "MetricsRegistry", "Series",
    "Profiler", "Span",
    "FlightRecorder",
    "Reporter",
    "DecisionRecord", "DecisionTrace", "KeepEntry",
]
