"""Resilient run harness (PyTorch port of ``consul_tpu/runtime``):
checkpoint policy and SIGTERM trap (:mod:`policy`), the heartbeat
deadline and the child-process init watchdog (:mod:`watchdog`),
:func:`harness.run_resilient`, the chunked run loop that resumes
bit-identically after a kill, and the memory planner
(:mod:`membudget`: :class:`MemoryPlan`, :func:`plan_memory`). The sentinel's host
tier lives where counters flush (models/cluster.py) and is re-exported
here as :class:`SentinelViolation`."""

from consul_tpu_torch.models.cluster import SentinelViolation
from consul_tpu_torch.models.counters import SENTINEL_FIELDS, violation_mask
from consul_tpu_torch.runtime.harness import (
    Preempted, RunReport, diagnostic_dump_path, hang_dump_path, restore_placed,
    run_resilient)
from consul_tpu_torch.runtime.membudget import MemoryPlan
from consul_tpu_torch.runtime.membudget import plan as plan_memory
from consul_tpu_torch.runtime.policy import CheckpointPolicy, SignalTrap
from consul_tpu_torch.runtime.watchdog import (
    FailoverRefused, HeartbeatMonitor, InitWatchdog, with_failover)

__all__ = [
    "CheckpointPolicy",
    "FailoverRefused",
    "HeartbeatMonitor",
    "InitWatchdog",
    "MemoryPlan",
    "Preempted",
    "RunReport",
    "SENTINEL_FIELDS",
    "SentinelViolation",
    "SignalTrap",
    "diagnostic_dump_path",
    "hang_dump_path",
    "plan_memory",
    "restore_placed",
    "run_resilient",
    "violation_mask",
    "with_failover",
]
