"""SpMM execution dispatch (see :mod:`repro_torch.exec.executor`)."""
from repro_torch.exec.executor import PlanExecutor

__all__ = ["PlanExecutor"]
