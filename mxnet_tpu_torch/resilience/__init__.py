"""Resilience layer of the port: deterministic fault injection, one
retry/backoff policy, thread watchdogs, and the training supervisor
(counterpart of ``mxnet_tpu/resilience/``; the supervisor rewinds to a
``checkpoint.CheckpointManager``'s newest checkpoint).

    from mxnet_tpu_torch.resilience import fault_point, RetryPolicy

Fault injection is configured by ``MXNET_TPU_FAULT_SPEC`` and is a
zero-overhead no-op when the spec is unset.
"""
from . import faults, watchdog
from .faults import (fault_point, configure, reset, enabled, stats,
                     register_exception, FaultInjected, TransientError)
from .retry import RetryPolicy, RETRYABLE_DEFAULT, retry_call
from .watchdog import Watchdog, Heartbeat, watchdog
from .supervisor import (TrainingSupervisor, NumericDivergence,
                         TrainingStalled, supervisor_from_env)

__all__ = ["fault_point", "configure", "reset", "enabled", "stats",
           "register_exception", "FaultInjected", "TransientError",
           "RetryPolicy", "RETRYABLE_DEFAULT", "retry_call", "Watchdog",
           "Heartbeat", "watchdog", "faults", "TrainingSupervisor",
           "NumericDivergence", "TrainingStalled", "supervisor_from_env"]
