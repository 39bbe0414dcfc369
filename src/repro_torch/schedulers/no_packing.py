"""No-Packing Scheduler (§6.1): one task per instance, each on its
reservation-price type — the strategy of most existing cloud cluster
managers, and the cost-normalization baseline for all experiments."""
from ..core.scheduler import NoPackingScheduler

__all__ = ["NoPackingScheduler"]
