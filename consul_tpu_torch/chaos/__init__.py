"""Fault schedules compiled to device tensors (PyTorch port of
``consul_tpu/chaos``): the host entries, the compiled
:class:`ChaosSchedule` and its per-tick evaluation. The scenario-sweep
plane (S scenarios per formed simulation, the Pareto table over view-graph
families) is ``chaos/sweep.py``."""

from consul_tpu_torch.chaos.schedule import (  # noqa: F401
    MAX_LINKS,
    MAX_PARTITIONS,
    MAX_RAFT_EVENTS,
    ChaosSchedule,
    ChurnWave,
    Degrade,
    LinkLoss,
    NodeTerms,
    Partition,
    RaftKill,
    RaftPartition,
    RaftStorm,
    compile_schedule,
    digest_of,
    down_at,
    empty,
    fault_started,
    is_empty,
    node_terms,
    or_none,
    pack_terms,
    pair_ok,
    place,
    roll_terms,
    shard_once,
    shift_schedule,
    static_key_of,
    to_device,
    unpack_terms,
)
