"""Pressure signals and the bus that delivers them.

Before the policy-layer refactor the simulator owned three parallel
pressure wirings — spot revocation notices (``on_preemption_notice``),
credit exhaustion (``on_credit_pressure``) and deferral latest-start
deadlines (``on_deadline_pressure``) — each its own callback + an
immediate extra scheduling round.  ``PressureBus`` replaces the trio with
one channel: the simulator *publishes* a ``PressureSignal`` and every
subscriber (normally just ``scheduler.on_pressure``, which fans out to the
policy stack and to the legacy per-kind hooks) receives it exactly once.

The bus is deliberately tiny and dependency-free: the delivery guarantee
("each signal reaches each subscriber exactly once, and coincident signals
do not double-fire the reaction round") lives here and in the simulator's
round de-duplication, and is pinned by ``tests/test_policies.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Set, Tuple

# signal kinds (the former three parallel wirings, plus the serving axis)
SPOT = "spot"          # revocation notice: instance ids about to be reclaimed
CREDIT = "credit"      # burstable credits exhausted: instance ids throttled
DEADLINE = "deadline"  # deferral latest-start reached: job ids to force-admit
SLO = "slo"            # service job entered utility risk: job ids at risk
KINDS = (SPOT, CREDIT, DEADLINE, SLO)


@dataclasses.dataclass(frozen=True)
class PressureSignal:
    """One scheduler-visible pressure event.

    ``ids`` are instance ids for ``spot``/``credit`` signals and job ids
    for ``deadline``/``slo`` signals — the same payloads the three legacy
    hooks carried, plus the serving axis.
    """

    kind: str
    ids: Tuple[int, ...]
    time: float


def dirty_instance_ids(signals: Iterable[PressureSignal]) -> Set[int]:
    """Union of the *instance* ids the given signals touched — the dirty
    set for incremental partial reconfiguration.  ``spot`` and ``credit``
    signals carry instance ids; ``deadline`` and ``slo`` signals carry job
    ids (their tasks enter the re-plan through the pending set, not through
    a dirty instance), so they contribute nothing here.
    """
    dirty: Set[int] = set()
    for s in signals:
        if s.kind in (SPOT, CREDIT):
            dirty.update(s.ids)
    return dirty


class PressureBus:
    """Exactly-once fan-out of pressure signals to subscribers.

    The simulator owns one bus per run and publishes every pressure event
    through it; subscribers are callables taking a ``PressureSignal``.
    ``published`` / ``delivered`` are observability counters (``delivered``
    counts subscriber deliveries, so it equals ``published`` × the
    subscriber count when nothing unsubscribes mid-run).
    """

    def __init__(self) -> None:
        self._subscribers: List[Callable[[PressureSignal], None]] = []
        self.published = 0
        self.delivered = 0

    def subscribe(self, fn: Callable[[PressureSignal], None]) -> None:
        self._subscribers.append(fn)

    def publish(self, signal: PressureSignal) -> None:
        self.published += 1
        for fn in self._subscribers:
            fn(signal)
            self.delivered += 1
