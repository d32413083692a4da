"""Fault-tolerant training runtime: checkpoint/resume, stragglers,
failure injection."""
from repro_torch.runtime.fault_tolerance import (FaultTolerantRunner,
                                                 RunnerConfig,
                                                 SimulatedFailure,
                                                 StragglerMonitor)

__all__ = ["FaultTolerantRunner", "RunnerConfig", "SimulatedFailure",
           "StragglerMonitor"]
