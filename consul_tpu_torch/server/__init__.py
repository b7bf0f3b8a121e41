"""Host-side server pieces the port needs (copies of the reference's
jax-free modules; see each module): the state store, FSM and raft core,
the WAN router and RTT math, and the control plane that owns them:
``endpoints.Server`` / ``ServerCluster``, the leader's reconcile, ACLs,
the Connect CA, discovery chains, prepared queries, autopilot, and the
serf plumbing that reads the simulation into the catalog."""

from consul_tpu_torch.server import (acl, autopilot, connect_ca,  # noqa: F401
                                     discovery_chain, endpoints, fsm, leader,
                                     prepared_query, raft, raft_store, router,
                                     rtt, serf_plumbing, state_store)

__all__ = ["acl", "autopilot", "connect_ca", "discovery_chain", "endpoints",
           "fsm", "leader", "prepared_query", "raft", "raft_store", "router",
           "rtt", "serf_plumbing", "state_store"]
