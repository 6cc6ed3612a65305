from repro_torch.runtime.straggler import StragglerDetector, StragglerReport
from repro_torch.runtime.fault_tolerance import Watchdog, GroupHealth
from repro_torch.runtime.elastic import ElasticController

__all__ = ["StragglerDetector", "StragglerReport", "Watchdog", "GroupHealth",
           "ElasticController"]
