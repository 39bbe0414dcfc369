# Composable policy-layer stack: one scenario axis = one PolicyLayer, a
# PolicyStack owns ordering/composition, and a PressureBus replaces the
# three parallel spot/credit/deadline pressure wirings.
from .base import PLANNING, SNAPSHOT, PolicyLayer, PolicyStack
from .layers import (AdmissionLayerBase, AutoscaleLayer, CreditLayer,
                     MultiRegionLayer, RegionPinLayer, SpotLayer,
                     stack_from_flags)
from .portfolio import PortfolioLayer
from .pressure import (CREDIT, DEADLINE, KINDS, SLO, SPOT, PressureBus,
                       PressureSignal, dirty_instance_ids)
from .slo import SLOLayer
from .stability import StabilityController, StabilityLayer

__all__ = [
    "PLANNING", "SNAPSHOT", "PolicyLayer", "PolicyStack",
    "AdmissionLayerBase", "AutoscaleLayer", "CreditLayer",
    "MultiRegionLayer", "PortfolioLayer", "RegionPinLayer", "SpotLayer",
    "stack_from_flags",
    "CREDIT", "DEADLINE", "KINDS", "SLO", "SPOT", "PressureBus",
    "PressureSignal", "dirty_instance_ids",
    "SLOLayer",
    "StabilityController", "StabilityLayer",
]
