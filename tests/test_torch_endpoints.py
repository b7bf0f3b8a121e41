"""PyTorch port vs the JAX reference: the server's RPC surface
(``consul_tpu_torch/server/endpoints.py``: ``Server``, ``ServerCluster``,
``federate``, ``NoPathToDatacenter``; ``server/leader.py``;
``server/autopilot.py``), copies of the reference's.

Each case runs one of the reference's own flows against the reference's
``ServerCluster`` and then against the port's, same seed, and holds the
transcripts of every public call equal: every RPC with its arguments and
its reply or error, and every reconcile, autopilot and router answer
(``tests/torch_server_parity.py``; ids drawn from one seeded ``uuid4``
sequence on both sides). The flows are the reference's tests of the
catalog, health, KV, sessions, txn and coordinate batching
(tests/test_endpoints.py), ACL bootstrap and token CRUD
(tests/test_acl.py), intentions (tests/test_intentions.py), config entries
(tests/test_config_entries.py), operator raft and autopilot and the
internal node dump (tests/test_operator_internal.py), reconcile, session
TTLs and autopilot promotion (tests/test_leader_router.py), ``?dc=``
forwarding and ``NoPathToDatacenter`` (tests/test_forward_dc.py), prepared
queries with failover over ``federate``d DCs (tests/test_prepared_query.py)
and the Connect CA endpoint (tests/test_connect_ca.py). Their agent and
HTTP parts wait for the port's agent tier.
"""

import pytest

import test_acl
import test_config_entries
import test_endpoints
import test_forward_dc
import test_intentions
import test_leader_router
import test_operator_internal
import test_prepared_query
import test_serf_plumbing
import torch_server_parity as sp

CASES = (
    sp.flows(test_endpoints, [
        "TestCatalogHealth.test_register_via_follower_forwards",
        "TestCatalogHealth.test_passing_only_filters_critical",
        "TestCatalogHealth.test_passing_only_excludes_warning",
        "TestCatalogHealth.test_session_create_validates_node",
        "TestCatalogHealth.test_status_endpoint",
        "TestKVSession.test_kv_roundtrip_and_blocking_index",
        "TestKVSession.test_session_lock_via_txn",
        "TestKVSession.test_txn_atomicity",
        "TestCoordinates.test_update_batches_through_raft",
        "TestCoordinates.test_update_validates",
        "TestCoordinates.test_update_via_follower_forwards_to_leader",
        "TestCoordinates.test_rate_limit_discards",
        "TestCoordinates.test_dedupe_by_node_segment",
        "TestRTTSort.test_near_sorting",
        "TestRTTSort.test_unknown_coordinate_sorts_last",
        "TestServerDurability.test_cluster_kv_survives_cold_restart"])
    + sp.flows(test_acl, [
        "TestEndpoints.test_bootstrap_once",
        "TestEndpoints.test_policy_and_token_crud_replicate",
        "TestEndpoints.test_token_with_unknown_policy_rejected",
        "TestEndpoints.test_bad_rules_rejected_before_commit"])
    + sp.flows(test_intentions, [
        "TestEndpoint.test_crud_replicates",
        "TestEndpoint.test_validation",
        "TestEndpoint.test_duplicate_pair_is_verdict",
        "TestEndpoint.test_match_and_check_precedence"])
    + sp.flows(test_config_entries, [
        "TestConfigEntryRPC.test_apply_get_roundtrip",
        "TestConfigEntryRPC.test_get_absent_is_none",
        "TestConfigEntryRPC.test_list_filters_by_kind",
        "TestConfigEntryRPC.test_cas_set_semantics",
        "TestConfigEntryRPC.test_delete_and_cas_delete"])
    + sp.flows(test_operator_internal, [
        "TestOperatorRaft.test_get_configuration_lists_members",
        "TestOperatorRaft.test_configuration_from_follower_view",
        "TestOperatorRaft.test_remove_live_follower_converges",
        "TestOperatorRaft.test_remove_leader_itself_answers_then_halts",
        "TestOperatorRaft.test_remove_unknown_peer_is_an_error",
        "TestOperatorRaft.test_remove_guard_refuses_quorum_break",
        "TestOperatorRaft.test_remove_forwards_from_follower",
        "TestOperatorAutopilot.test_get_returns_defaults_when_unset",
        "TestOperatorAutopilot.test_set_replicates_and_cas",
        "TestOperatorAutopilot.test_get_put_roundtrip_accepts_modify_index",
        "TestOperatorAutopilot.test_operator_knobs_drive_health_scoring",
        "TestOperatorAutopilot.test_unknown_keys_rejected",
        "TestOperatorAutopilot.test_autopilot_loop_reads_live_config",
        "TestInternal.test_node_dump_aggregates",
        "TestInternal.test_node_info_single"])
    + sp.flows(test_leader_router, [
        "TestReconcile.test_alive_member_registered_with_serf_health",
        "TestReconcile.test_alive_noop_when_in_sync",
        "TestReconcile.test_failed_member_marked_critical_not_removed",
        "TestReconcile.test_left_member_deregistered",
        "TestReconcile.test_failed_unknown_member_is_noop",
        "TestReconcile.test_vanished_member_reaped_from_catalog",
        "TestReconcile.test_externally_registered_node_not_reaped",
        "TestReconcile.test_follower_reconcile_is_noop",
        "TestSessionTTL.test_expire_after_2x_ttl",
        "TestSessionTTL.test_renew_pushes_deadline",
        "TestSessionTTL.test_session_renew_rpc",
        "TestAutopilot.test_healthy_cluster",
        "TestAutopilot.test_dead_server_pruned_with_quorum",
        "TestAutopilot.test_no_prune_when_quorum_would_break",
        "TestAutopilot.test_can_remove_servers_rule",
        "TestAutopilotPromotion.test_stats_fetcher_reports_all_servers",
        "TestAutopilotPromotion.test_nonvoter_replicates_but_no_suffrage",
        "TestAutopilotPromotion.test_promote_after_stable",
        "TestAutopilotPromotion.test_no_promote_while_lagging",
        "TestAutopilotPromotion.test_promotion_clock_resets_on_unhealthy",
        "TestAutopilotPromotion.test_promoted_voter_counts_for_quorum"])
    + sp.flows(test_forward_dc, [
        "TestDatacenterListings.test_catalog_list_datacenters_sorted",
        "TestDatacenterListings.test_coordinate_list_datacenters",
        "TestForwardDC.test_kv_query_answers_from_remote_dc",
        "TestForwardDC.test_catalog_query_remote_dc",
        "TestForwardDC.test_local_dc_value_is_not_forwarded",
        "TestForwardDC.test_failover_rotates_past_down_server",
        "TestForwardDC.test_no_path_when_whole_dc_down",
        "TestForwardDC.test_unknown_dc_raises",
        "TestForwardDC.test_global_rpc_fans_out_to_all_dcs",
        "TestForwardDC.test_global_rpc_reports_dead_dc_error"])
    + sp.flows(test_prepared_query, [
        "TestEndpoint.test_crud_and_execute",
        "TestEndpoint.test_replicated_to_followers",
        "TestEndpoint.test_name_collision_is_apply_verdict",
        "TestEndpoint.test_session_bound_query_dies_with_session",
        "TestEndpoint.test_only_passing_filter",
        "TestEndpoint.test_near_sort_pins_node_first",
        "TestEndpoint.test_template_execute_by_rendered_name",
        "TestEndpoint.test_limit_applies",
        "TestFailover.test_failover_to_remote_dc",
        "TestFailover.test_failover_explicit_list_skips_unknown",
        "TestFailover.test_no_failover_when_not_configured"])
    + sp.flows(test_serf_plumbing, [
        "TestLanEventHandler.test_join_fail_reap_to_catalog",
        "TestLanEventHandler.test_bootstrap_expect_via_member_events"])
)


@pytest.mark.parametrize("mod, cls, fn, params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_rpc_flow_matches_reference(monkeypatch, tmp_path, mod, cls, fn,
                                    params):
    sp.assert_same(monkeypatch, mod, cls, fn, params, tmp_path=tmp_path)


@pytest.mark.parametrize("case", [
    "TestEndpoint.test_sign_verifies_against_served_root",
    "TestEndpoint.test_rotation_keeps_old_root_inactive"])
def test_connect_ca_endpoint_matches_reference(monkeypatch, tmp_path, case):
    """The CA endpoint's lazy init, Sign and rotation: roots and leaves
    compared by subject, issuer, SPIFFE SAN and CA flag, root ids by the
    order they were minted."""
    pytest.importorskip("cryptography", reason="the Connect CA mints real "
                        "X.509 material (the reference skips alike)")
    import test_connect_ca

    (_, _, cls, fn, params), = sp.flows(test_connect_ca, [case])
    log = sp.assert_same(monkeypatch, test_connect_ca, cls, fn, params,
                         tmp_path=tmp_path)
    assert any(e[0] == "Server.rpc" and e[1] == ["ConnectCA.Sign"]
               for e in log) or any(e[0] == "sign_leaf" for e in log)


def test_port_server_tier_imports_no_reference():
    """The port's copies stand alone: their module objects and every
    class the flows touch come from consul_tpu_torch."""
    from consul_tpu_torch.server import endpoints, leader

    assert endpoints.ServerCluster.__module__ == \
        "consul_tpu_torch.server.endpoints"
    assert leader.Server is endpoints.Server
    assert endpoints.RaftCluster.__module__ == "consul_tpu_torch.server.raft"
    assert endpoints.Sink.__module__ == "consul_tpu_torch.utils.telemetry"
    assert endpoints.StateStore.__module__ == \
        "consul_tpu_torch.server.state_store"
