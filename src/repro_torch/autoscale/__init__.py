# Price-pressure autoscaling: horizon price forecasts + forecast-driven
# admission control / deadline-bounded deferral of the job population.
from .admission import (ADMIT_OVERHEAD_S, RUNTIME_MARGIN, AdmissionController,
                        latest_start_s)
from .forecast import (OUForecaster, PersistenceForecaster, PriceForecaster,
                       RegionForecaster, TraceForecaster)

__all__ = ["ADMIT_OVERHEAD_S", "RUNTIME_MARGIN", "AdmissionController",
           "latest_start_s", "OUForecaster", "PersistenceForecaster",
           "PriceForecaster", "RegionForecaster", "TraceForecaster"]
