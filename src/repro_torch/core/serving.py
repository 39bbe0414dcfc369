"""Latency-SLO serving primitives: utility curves, request profiles, queueing.

Eva's market prices *batch* work by reservation price; this module supplies
the vocabulary for the online-serving axis, where a job is a fleet of
inference replicas and its value is a smooth function of served latency
rather than a completion time.  Following the utility/cost framing of
Haritha & Singh (arXiv 2201.09050), hard ``deadline_s`` cutoffs are replaced
by a per-job :class:`UtilityCurve` — full utility while p99 latency is at or
below target, smooth exponential decay beyond it.

The latency model is deliberately coarse (an M/M/1-style amplification of a
base service latency by ``1 / (1 - rho)``): the point is not queueing-theory
fidelity but a monotone, closed-form map from *capacity headroom* to *p99
latency* that the simulator can bill deterministically and a policy layer
can invert (``max_utilization`` below) to know how much headroom keeps the
SLO safe.

Everything here is pure (numpy + math only, no simulator or catalog
imports) so traces, the simulator, and policy layers can all share it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence, Tuple

import numpy as np

__all__ = [
    "UtilityCurve",
    "RequestProfile",
    "ServiceSpec",
    "p99_latency_ms",
    "p99_latency_ms_np",
    "utility_np",
]


def p99_latency_ms(base_ms: float, rho: float) -> float:
    """p99 latency of a replica fleet at utilization ``rho``.

    ``base_ms`` is the unloaded p99 (queueing-free service latency); load
    amplifies it by ``1 / (1 - rho)``.  At or beyond saturation the queue
    diverges and latency is infinite.
    """
    if rho < 0.0:
        rho = 0.0
    if rho >= 1.0:
        return math.inf
    return base_ms / (1.0 - rho)


def p99_latency_ms_np(base_ms: np.ndarray, rho: np.ndarray) -> np.ndarray:
    """Vectorized :func:`p99_latency_ms` over aligned arrays.

    The division is the same IEEE double op per lane as the scalar path, so
    finite lanes match bit-for-bit; saturated lanes (``rho >= 1``) are
    ``inf`` just like the scalar.
    """
    base_ms = np.asarray(base_ms, dtype=np.float64)
    rho = np.maximum(np.asarray(rho, dtype=np.float64), 0.0)
    sat = rho >= 1.0
    return np.where(sat, np.inf, base_ms / np.where(sat, 0.5, 1.0 - rho))


def utility_np(latency_ms: np.ndarray, target_p99_ms: np.ndarray,
               softness_ms: np.ndarray, floor: np.ndarray) -> np.ndarray:
    """Vectorized :meth:`UtilityCurve.utility` over aligned arrays.

    Lanes at/below target get exactly 1.0 and non-finite lanes exactly
    ``floor``, same as the scalar; decaying lanes use ``np.exp`` where the
    scalar uses ``math.exp``, which may differ in the last ulp — within the
    simulator's documented <=1e-9 relative tolerance for utility integrals.
    """
    lat = np.asarray(latency_ms, dtype=np.float64)
    decay = np.exp(-np.maximum(lat - target_p99_ms, 0.0) / softness_ms)
    u = floor + (1.0 - floor) * decay
    u = np.where(lat <= target_p99_ms, 1.0, u)
    return np.where(np.isfinite(lat), u, floor)


@dataclass(frozen=True)
class UtilityCurve:
    """Smooth latency-utility curve: 1.0 at/below the p99 target, then
    exponential decay with scale ``softness_ms`` down to ``floor``.

    Monotone non-increasing and continuous in latency — the smooth
    replacement for a hard deadline cliff.
    """

    target_p99_ms: float
    softness_ms: float = 100.0
    floor: float = 0.0

    def utility(self, latency_ms: float) -> float:
        if not math.isfinite(latency_ms):
            return self.floor
        if latency_ms <= self.target_p99_ms:
            return 1.0
        decay = math.exp(-(latency_ms - self.target_p99_ms) / self.softness_ms)
        return self.floor + (1.0 - self.floor) * decay


@dataclass(frozen=True)
class RequestProfile:
    """Piecewise-constant request rate over time.

    ``times_s`` are ascending breakpoints; ``rps[i]`` holds on
    ``[times_s[i], times_s[i+1])``.  Before ``times_s[0]`` the rate is 0.
    The simulator schedules a rate-update event at every breakpoint, so
    billing integrals only ever see segments of constant rate.
    """

    times_s: Tuple[float, ...]
    rps: Tuple[float, ...]
    _times: np.ndarray = field(init=False, repr=False, compare=False)
    _rps: np.ndarray = field(init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        t = np.asarray(self.times_s, dtype=np.float64)
        r = np.asarray(self.rps, dtype=np.float64)
        if t.shape != r.shape or t.ndim != 1 or t.size == 0:
            raise ValueError("times_s and rps must be equal-length 1-D")
        if np.any(np.diff(t) <= 0):
            raise ValueError("times_s must be strictly increasing")
        object.__setattr__(self, "_times", t)
        object.__setattr__(self, "_rps", r)

    def rate_at(self, t: float) -> float:
        i = int(np.searchsorted(self._times, t, side="right")) - 1
        return float(self._rps[i]) if i >= 0 else 0.0

    def breakpoints_between(self, start_s: float,
                            end_s: float) -> Tuple[float, ...]:
        """Breakpoints strictly inside ``(start_s, end_s)``."""
        m = (self._times > start_s) & (self._times < end_s)
        return tuple(self._times[m].tolist())

    def segments(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(times_s, rps)`` as the profile's precomputed breakpoint
        arrays.  Consumers that walk time monotonically (the simulator's
        accrual sweeps) cache these once and advance a segment cursor
        instead of re-searching the piecewise representation per call.
        Treat as read-only: both arrays are the profile's own state.
        """
        return self._times, self._rps

    def peak_rps(self) -> float:
        return float(self._rps.max())

    @staticmethod
    def diurnal(peak_rps: float, *, start_s: float = 0.0,
                duration_s: float = 24 * 3600.0, step_s: float = 900.0,
                trough: float = 0.3, peak_hour: float = 14.0,
                surges: Sequence[Tuple[float, float, float]] = (),
                ) -> "RequestProfile":
        """Diurnal load on a step grid: sinusoid between ``trough*peak_rps``
        (at ``peak_hour - 12h``) and ``peak_rps`` (at ``peak_hour``),
        multiplied by ``mult`` inside each surge window ``(t0_s, t1_s,
        mult)``.  Snap surge edges to the grid yourself if you need the
        simulator to see them exactly.
        """
        times = np.arange(start_s, start_s + duration_s, step_s, dtype=np.float64)
        hours = times / 3600.0
        shape = 0.5 * (1.0 - np.cos(2.0 * np.pi * (hours - peak_hour) / 24.0 + np.pi))
        rps = peak_rps * (trough + (1.0 - trough) * shape)
        for t0, t1, mult in surges:
            rps = np.where((times >= t0) & (times < t1), rps * mult, rps)
        return RequestProfile(tuple(times.tolist()), tuple(rps.tolist()))


@dataclass(frozen=True)
class ServiceSpec:
    """Per-job serving contract: request load, utility curve, and replica
    capacity.  A service job's tasks are interchangeable replicas; fleet
    capacity is ``per_replica_rps`` summed over replicas, scaled by each
    replica's observed throughput (interference / throttling degrade
    serving rate exactly like batch iteration rate).
    """

    requests: RequestProfile
    utility: UtilityCurve
    per_replica_rps: float
    base_latency_ms: float
    # utilization fraction of max_utilization at which the job counts as
    # "at utility risk" (SLO pressure fires on the rising edge)
    risk_fraction: float = 0.8

    def max_utilization(self) -> float:
        """Highest utilization at which p99 still meets target:
        base/(1-rho) <= target  ⇒  rho <= 1 - base/target."""
        t = self.utility.target_p99_ms
        if t <= self.base_latency_ms:
            return 0.0
        return 1.0 - self.base_latency_ms / t

    def p99_ms(self, rps: float, capacity_rps: float) -> float:
        if rps <= 0.0:
            return self.base_latency_ms
        if capacity_rps <= 0.0:
            return math.inf
        return p99_latency_ms(self.base_latency_ms, rps / capacity_rps)

    def at_risk(self, rps: float, capacity_rps: float) -> bool:
        """True when load sits within the risk margin of the SLO-feasible
        utilization ceiling (or capacity is short entirely)."""
        if rps <= 0.0:
            return False
        if capacity_rps <= 0.0:
            return True
        ceiling = self.risk_fraction * self.max_utilization()
        return rps / capacity_rps >= ceiling
