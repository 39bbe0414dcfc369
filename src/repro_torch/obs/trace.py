"""Per-round planner explain records — why each adopt/evict/veto happened.

``DecisionTrace`` collects one ``DecisionRecord`` per scheduling round,
emitted by ``EvaScheduler.schedule`` when a ``FlightRecorder`` is
attached.  Each record snapshots, at the moment the decision was made:

* the reservation-price landscape (count/min/mean/max over the round's
  planning catalog) and the D̂ horizon the ensemble used;
* the per-instance **keep table**: TNRP saving S, hourly cost ΔM, the
  summed ``keep_bonus`` slack *decomposed by contributing layer*, and the
  resulting keep/evict margin — the S·D̂ > ΔM test made attributable;
* ``type_mask`` / ``region_caps`` provenance (which layer contributed);
* the ensemble arithmetic (S_f, M_f, S_p, M_p, adopt_full) or, for a
  pressure round, the forced-partial context (evacuated instances,
  resumed jobs, incremental dirty set + fallback reason);
* per-layer counter deltas across ``refine`` (arbitrage moves, SLO move
  vetoes, ...), so post-pass rewrites are attributable to their layer.

The trace is a pure observer: the scheduler computes records from the
same inputs the decision used (re-running only pure evaluation helpers),
so recording cannot change a decision — pinned by ``tests/test_obs.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class KeepEntry:
    """One live instance through the keep test."""

    instance_id: int
    type_index: int
    saving: float            # S: TNRP saving of keeping the set ($/h)
    cost: float              # ΔM stand-in: the instance's hourly cost
    bonus: float             # summed keep_bonus slack ($/h)
    bonus_by_layer: Dict[str, float]
    kept: bool               # S >= ΔM - bonus (the planner's keep test)

    @property
    def margin(self) -> float:
        """Positive = kept with room; negative = evicted by this much."""
        return self.saving - (self.cost - self.bonus)

    def to_dict(self) -> dict:
        return {"instance_id": self.instance_id,
                "type_index": self.type_index,
                "saving": self.saving, "cost": self.cost,
                "bonus": self.bonus, "bonus_by_layer": self.bonus_by_layer,
                "margin": self.margin, "kept": self.kept}


@dataclasses.dataclass
class DecisionRecord:
    t: float
    round_index: int
    kind: str                    # "ensemble" | "full-only" | "partial-only"
    #                            # | "forced-partial"
    d_hat_s: float
    n_tasks: int = 0
    n_pending: int = 0
    rp_min: float = 0.0
    rp_mean: float = 0.0
    rp_max: float = 0.0
    keep_table: List[KeepEntry] = dataclasses.field(default_factory=list)
    mask_layers: Tuple[str, ...] = ()      # type_mask provenance
    caps_layer: Optional[str] = None       # region_caps provenance
    # ensemble rounds
    s_full: Optional[float] = None
    m_full: Optional[float] = None
    s_partial: Optional[float] = None
    m_partial: Optional[float] = None
    adopt_full: Optional[bool] = None
    # forced-partial rounds
    evacuated: Tuple[int, ...] = ()
    resumed_jobs: Tuple[int, ...] = ()
    dirty: Tuple[int, ...] = ()
    incremental_fallback: Optional[str] = None
    # per-layer counter deltas across refine (vetoes, arbitrage moves, ...)
    refine_deltas: Dict[str, float] = dataclasses.field(default_factory=dict)

    def keep_entry(self, iid: int) -> Optional[KeepEntry]:
        for e in self.keep_table:
            if e.instance_id == iid:
                return e
        return None

    def to_dict(self) -> dict:
        d = {"t": self.t, "round_index": self.round_index, "kind": self.kind,
             "d_hat_s": self.d_hat_s, "n_tasks": self.n_tasks,
             "n_pending": self.n_pending, "rp_min": self.rp_min,
             "rp_mean": self.rp_mean, "rp_max": self.rp_max,
             "keep_table": [e.to_dict() for e in self.keep_table],
             "mask_layers": list(self.mask_layers),
             "caps_layer": self.caps_layer}
        if self.kind == "forced-partial":
            d["evacuated"] = list(self.evacuated)
            d["resumed_jobs"] = list(self.resumed_jobs)
            d["dirty"] = list(self.dirty)
            d["incremental_fallback"] = self.incremental_fallback
        if self.adopt_full is not None:
            d.update({"s_full": self.s_full, "m_full": self.m_full,
                      "s_partial": self.s_partial,
                      "m_partial": self.m_partial,
                      "adopt_full": self.adopt_full})
        if self.refine_deltas:
            d["refine_deltas"] = self.refine_deltas
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DecisionRecord":
        keep = [KeepEntry(instance_id=e["instance_id"],
                          type_index=e["type_index"], saving=e["saving"],
                          cost=e["cost"], bonus=e["bonus"],
                          bonus_by_layer=dict(e.get("bonus_by_layer", {})),
                          kept=e["kept"])
                for e in d.get("keep_table", [])]
        return cls(t=float(d["t"]), round_index=int(d["round_index"]),
                   kind=d["kind"], d_hat_s=float(d["d_hat_s"]),
                   n_tasks=int(d.get("n_tasks", 0)),
                   n_pending=int(d.get("n_pending", 0)),
                   rp_min=float(d.get("rp_min", 0.0)),
                   rp_mean=float(d.get("rp_mean", 0.0)),
                   rp_max=float(d.get("rp_max", 0.0)),
                   keep_table=keep,
                   mask_layers=tuple(d.get("mask_layers", ())),
                   caps_layer=d.get("caps_layer"),
                   s_full=d.get("s_full"), m_full=d.get("m_full"),
                   s_partial=d.get("s_partial"),
                   m_partial=d.get("m_partial"),
                   adopt_full=d.get("adopt_full"),
                   evacuated=tuple(d.get("evacuated", ())),
                   resumed_jobs=tuple(d.get("resumed_jobs", ())),
                   dirty=tuple(d.get("dirty", ())),
                   incremental_fallback=d.get("incremental_fallback"),
                   refine_deltas=dict(d.get("refine_deltas", {})))


class DecisionTrace:
    """Append-only list of per-round decision records."""

    def __init__(self) -> None:
        self.records: List[DecisionRecord] = []

    def append(self, rec: DecisionRecord) -> None:
        self.records.append(rec)

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self):
        return iter(self.records)

    def at_or_before(self, t: float) -> Optional[DecisionRecord]:
        """Latest record with timestamp <= t (the round that decided the
        state in force at ``t``)."""
        best = None
        for r in self.records:
            if r.t <= t:
                best = r
        return best

    def last_keep_entry(self, iid: int, before_t: float
                        ) -> Tuple[Optional[DecisionRecord],
                                   Optional[KeepEntry]]:
        """Most recent round at/before ``before_t`` whose keep table saw
        instance ``iid`` — the round that decided its fate."""
        for r in reversed(self.records):
            if r.t > before_t:
                continue
            e = r.keep_entry(iid)
            if e is not None:
                return r, e
        return None, None
