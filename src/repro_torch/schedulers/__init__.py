from .no_packing import NoPackingScheduler
from .stratus import StratusScheduler
from .synergy import SynergyScheduler
from .owl import OwlScheduler

__all__ = ["NoPackingScheduler", "StratusScheduler", "SynergyScheduler",
           "OwlScheduler"]
