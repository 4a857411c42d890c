"""Fault tolerance: restartable training, failure injection, straggler and
elasticity policy."""

from repro_torch.ft.elastic import (
    FailureInjector,
    RestartPolicy,
    SimulatedFailure,
    run_with_recovery,
    run_with_restarts,
    verify_acked_writes,
)

__all__ = ["FailureInjector", "RestartPolicy", "SimulatedFailure",
           "run_with_restarts", "run_with_recovery",
           "verify_acked_writes"]
