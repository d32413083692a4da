"""SpMM execution dispatch (see :mod:`repro_torch.exec.executor`)."""
from repro_torch.exec.executor import PlanExecutor, default_executor

__all__ = ["PlanExecutor", "default_executor"]
