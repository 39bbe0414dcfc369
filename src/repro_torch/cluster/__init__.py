# Simulated cloud substrate: event-driven cluster simulator + trace generators.
from .simulator import Metrics, SimConfig, Simulator
from .traces import (alibaba_like_trace, burstable_trace, deferrable_trace,
                     physical_trace, portfolio_trace, serving_trace)

__all__ = ["Metrics", "SimConfig", "Simulator", "alibaba_like_trace",
           "burstable_trace", "deferrable_trace", "physical_trace",
           "portfolio_trace", "serving_trace"]
