"""Ensemble criterion (§4.5): choose between Full and Partial Reconfiguration.

Adopt Full iff   S_F · D̂ − M_F  >  S_P · D̂ − M_P
with D̂ = −1/(λ ln(1−p)) the mean time to the next Full Reconfiguration,
where λ is the Poisson rate of events (job arrivals + completions) and p the
empirical probability that an event triggers a Full Reconfiguration.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Optional

import numpy as np

_P_CLAMP = (1e-3, 1.0 - 1e-3)


def mean_time_to_full_reconfig(lam: float, p: float) -> float:
    """D̂ = −1/(λ ln(1−p)), λ in events/second → D̂ in seconds."""
    p = min(max(p, _P_CLAMP[0]), _P_CLAMP[1])
    lam = max(lam, 1e-9)
    return -1.0 / (lam * math.log1p(-p))


@dataclasses.dataclass
class EnsembleDecision:
    adopt_full: bool
    s_full: float
    s_partial: float
    m_full: float
    m_partial: float
    d_hat_s: float


class EventRateEstimator:
    """Online estimation of λ (events/sec) and p (Full-trigger probability).

    λ: sliding window of recent event timestamps (default last 50 events);
    p: Laplace-smoothed ratio of Full adoptions to events.
    Priors before data: one event per 20 min (the trace generator default)
    and p = 0.5.
    """

    def __init__(self, window: int = 50, prior_interarrival_s: float = 1200.0,
                 prior_p: float = 0.5):
        self._times: Deque[float] = deque(maxlen=window)
        self._events = 0
        self._fulls = 0
        self._prior_lam = 1.0 / prior_interarrival_s
        self._prior_p = prior_p

    def on_event(self, time_s: float) -> None:
        self._times.append(time_s)
        self._events += 1

    def on_full_reconfig(self) -> None:
        self._fulls += 1

    @property
    def lam(self) -> float:
        if len(self._times) < 2:
            return self._prior_lam
        span = self._times[-1] - self._times[0]
        if span <= 0:
            return self._prior_lam
        return (len(self._times) - 1) / span

    @property
    def p(self) -> float:
        # Laplace smoothing with the prior as one pseudo-observation.
        return (self._fulls + self._prior_p) / (self._events + 1.0)

    def d_hat(self) -> float:
        return mean_time_to_full_reconfig(self.lam, self.p)


def instantaneous_saving(tnrps: np.ndarray, costs: np.ndarray) -> float:
    """S = Σ_i (TNRP(T_i) − C_i): hourly value retained beyond what is paid."""
    return float((tnrps - costs).sum())


def choose(s_full: float, m_full: float, s_partial: float, m_partial: float,
           d_hat_s: float) -> EnsembleDecision:
    d_hr = d_hat_s / 3600.0  # savings are $/hr, migration costs are $
    adopt = (s_full * d_hr - m_full) > (s_partial * d_hr - m_partial)
    return EnsembleDecision(adopt, s_full, s_partial, m_full, m_partial, d_hat_s)
