"""Deterministic testing utilities: fault injection + fake clock."""
from dedloc_tpu_torch.testing.faults import (  # noqa: F401
    FakeClock,
    Fault,
    FaultSchedule,
)
