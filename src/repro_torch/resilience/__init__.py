"""Fault tolerance: deterministic fault injection, shared backoff, and the
auto-resume supervisor (copies of ``repro/resilience/``)."""
from repro_torch.resilience.backoff import (  # noqa: F401
    BackoffPolicy,
    TransientError,
)
from repro_torch.resilience.faults import (  # noqa: F401
    Fault,
    FaultPlan,
    PermanentFault,
)
from repro_torch.resilience.supervisor import (  # noqa: F401
    RESTARTABLE_EXIT,
    PreemptionFlag,
    child_argv,
    install_preemption_handler,
    supervise,
)
