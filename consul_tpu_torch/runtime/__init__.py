"""Resilient run harness (PyTorch port of ``consul_tpu/runtime``):
checkpoint policy and SIGTERM trap (:mod:`policy`), the heartbeat
deadline (:mod:`watchdog`) and :func:`harness.run_resilient`, the chunked
run loop that resumes bit-identically after a kill. The sentinel's host
tier lives where counters flush (models/cluster.py) and is re-exported
here as :class:`SentinelViolation`."""

from consul_tpu_torch.models.cluster import SentinelViolation
from consul_tpu_torch.models.counters import SENTINEL_FIELDS, violation_mask
from consul_tpu_torch.runtime.harness import (
    Preempted, RunReport, diagnostic_dump_path, hang_dump_path, run_resilient)
from consul_tpu_torch.runtime.policy import CheckpointPolicy, SignalTrap
from consul_tpu_torch.runtime.watchdog import HeartbeatMonitor

__all__ = [
    "CheckpointPolicy",
    "HeartbeatMonitor",
    "Preempted",
    "RunReport",
    "SENTINEL_FIELDS",
    "SentinelViolation",
    "SignalTrap",
    "diagnostic_dump_path",
    "hang_dump_path",
    "run_resilient",
    "violation_mask",
]
