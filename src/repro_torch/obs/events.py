"""Typed, append-only structured event log — the flight recorder's spine.

Every lifecycle transition the simulator already models becomes one
``Event`` record: provision/terminate, migrate (+ egress), spot notices
and reclaims, credit throttles, defer/admit transitions, pool resizes,
SLO-risk edges and pressure-bus deliveries.  Records are sim-time-stamped
and carry only plain scalars (ints/floats/strings/short tuples), so the
log serializes losslessly to JSONL and replays deterministically.

The log is a *pure observer*: nothing in the simulator reads it back, it
draws no randomness, and with no log attached the emitting code paths are
bit-identical to the seed simulator (pinned by ``tests/test_obs.py``).

Cost attribution rides the same log: every dollar the simulator bills
flows through ``record_cost`` with a category (``instance`` / ``egress``
/ ``commitment``) and a ledger key (region or type name), aggregated into
running per-key sums — the event-cost conservation law
(``tests/test_invariants.py``) pins ``sum(log.costs.values()) ==
Metrics.total_cost`` on randomly composed traces.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

# --- event vocabulary (docs/OBSERVABILITY.md documents each kind) ---------
PROVISION = "provision"          # instance requested (iid, type, region)
READY = "ready"                  # instance finished acquisition + setup
TERMINATE = "terminate"          # instance released (lifetime, billed $)
MIGRATE = "migrate"              # task checkpointed toward a new instance
PLACE = "place"                  # pending task assigned a fresh slot
EGRESS = "egress"                # cross-region checkpoint transfer billed
NOTICE = "notice"                # spot revocation notice (reclaim imminent)
PREEMPT = "preempt"              # spot reclaim fired
FAILURE = "failure"              # instance failure (MTBF model)
CAPACITY_DENIED = "capacity_denied"  # launch refused: region at its cap
CREDIT_THROTTLE = "credit_throttle"  # burstable credits exhausted
DEFER_DEADLINE = "defer_deadline"    # deferrable job hit latest-start
ADMIT = "admit"                  # pending job first assigned (PENDING->ADMIT)
WITHDRAW = "withdraw"            # re-deferred placement released pre-launch
POOL_RESIZE = "pool_resize"      # commitment pool grown mid-run
SLO_RISK = "slo_risk"            # service utility risk edge (on/off)
PRESSURE = "pressure"            # PressureBus delivery (kind + ids)
JOB_ARRIVE = "job_arrive"
JOB_DONE = "job_done"
ROUND = "round"                  # scheduling round ran (decision indexed)

KINDS = (PROVISION, READY, TERMINATE, MIGRATE, PLACE, EGRESS, NOTICE,
         PREEMPT, FAILURE, CAPACITY_DENIED, CREDIT_THROTTLE, DEFER_DEADLINE,
         ADMIT, WITHDRAW, POOL_RESIZE, SLO_RISK, PRESSURE, JOB_ARRIVE,
         JOB_DONE, ROUND)

# cost-ledger categories (every billed dollar lands in exactly one)
COST_INSTANCE = "instance"       # per-second / spot-integrated instance bill
COST_EGRESS = "egress"           # cross-region checkpoint transfer fees
COST_COMMITMENT = "commitment"   # standing pool bills (used or idle)


@dataclasses.dataclass(frozen=True)
class Event:
    """One sim-time-stamped lifecycle record.

    ``instance_id`` / ``job_id`` are set when the event concerns one
    (``None`` otherwise); everything else lives in ``fields`` as plain
    scalars so the record round-trips through JSON unchanged.
    """

    t: float
    kind: str
    instance_id: Optional[int] = None
    job_id: Optional[int] = None
    fields: Tuple[Tuple[str, object], ...] = ()

    def get(self, key: str, default=None):
        for k, v in self.fields:
            if k == key:
                return v
        return default

    def to_dict(self) -> dict:
        d = {"t": self.t, "kind": self.kind}
        if self.instance_id is not None:
            d["instance_id"] = self.instance_id
        if self.job_id is not None:
            d["job_id"] = self.job_id
        d.update(dict(self.fields))
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Event":
        core = {"t", "kind", "instance_id", "job_id"}
        return cls(t=float(d["t"]), kind=d["kind"],
                   instance_id=d.get("instance_id"),
                   job_id=d.get("job_id"),
                   fields=tuple((k, v) for k, v in d.items()
                                if k not in core))


class EventLog:
    """Append-only event store + aggregated cost ledger.

    Query helpers are deliberately simple linear scans: the log is an
    offline analysis artifact (``tools/explain.py``), not a hot-path
    index.
    """

    def __init__(self) -> None:
        self.events: List[Event] = []
        # (category, key) -> running billed total; insertion-ordered, so
        # summing the values replays the accrual order deterministically
        self.costs: Dict[Tuple[str, str], float] = {}
        self.cost_entries = 0  # micro-charges folded into the ledger

    # -- emission -----------------------------------------------------------
    def emit(self, t: float, kind: str, *, instance_id: Optional[int] = None,
             job_id: Optional[int] = None, **fields) -> None:
        self.events.append(Event(t, kind, instance_id, job_id,
                                 tuple(sorted(fields.items()))))

    def record_cost(self, category: str, key: str, amount: float) -> None:
        """Fold one billed amount into the (category, key) ledger cell.

        Aggregation (not per-charge append) keeps the artifact bounded:
        spot billing accrues at every simulator event, which would
        otherwise dominate the log with micro-charges.
        """
        cell = (category, key)
        self.costs[cell] = self.costs.get(cell, 0.0) + amount
        self.cost_entries += 1

    # -- queries ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[Event]:
        return iter(self.events)

    def of_kind(self, *kinds: str) -> List[Event]:
        return [e for e in self.events if e.kind in kinds]

    def for_instance(self, iid: int) -> List[Event]:
        """Events naming the instance directly, plus pressure signals whose
        id payload contains it."""
        out = []
        for e in self.events:
            if e.instance_id == iid:
                out.append(e)
            elif e.kind == PRESSURE and iid in (e.get("ids") or ()):
                out.append(e)
        return out

    def for_job(self, jid: int) -> List[Event]:
        return [e for e in self.events if e.job_id == jid]

    def between(self, t0: float, t1: float) -> List[Event]:
        return [e for e in self.events if t0 <= e.t <= t1]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for e in self.events:
            out[e.kind] = out.get(e.kind, 0) + 1
        return out

    def total_cost(self) -> float:
        return sum(self.costs.values())

    def cost_by(self, axis: str = "category") -> Dict[str, float]:
        """Aggregate the ledger along ``category`` or ``key``."""
        i = 0 if axis == "category" else 1
        out: Dict[str, float] = {}
        for cell, v in self.costs.items():
            out[cell[i]] = out.get(cell[i], 0.0) + v
        return out
