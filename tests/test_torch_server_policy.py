"""PyTorch port vs the JAX reference: the server tier's policy modules
(``consul_tpu_torch/utils/{hcl,health}.py``, ``server/acl.py``,
``server/discovery_chain.py``, ``server/prepared_query.py``,
``server/connect_ca.py``), copies of the reference's.

Each case runs one of the reference's own tests twice, as written and
with the reference's modules swapped for the port's, and holds the
transcripts of every public call of these modules equal
(``tests/torch_server_parity.py``): hcl's parse on tests/test_hcl.py's
inputs; ACL policy parsing and the authorizer (tests/test_acl.py);
discovery-chain compiles on tests/test_discovery_chain.py's entries;
prepared-query normalization, template rendering and the health, tag and
meta filters (tests/test_prepared_query.py); the Connect CA's root and
leaf (tests/test_connect_ca.py), certificates compared by subject,
issuer, SAN and CA flag, since every root carries a fresh key. The
reference test's own assertions hold on both sides.
"""

import pytest

import test_acl
import test_discovery_chain
import test_hcl
import test_prepared_query
import torch_server_parity as sp

CASES = (
    sp.flows(test_hcl, [
        "TestValues.test_assignments",
        "TestValues.test_lists_and_nested_objects",
        "TestValues.test_string_escapes",
        "TestValues.test_comments_all_three_styles",
        "TestBlocks.test_block_is_object",
        "TestBlocks.test_labeled_block_chains_keys",
        "TestBlocks.test_repeated_blocks_deep_merge",
        "TestBlocks.test_repeated_scalar_collects_list",
        "TestErrors.test_unclosed_block",
        "TestErrors.test_bare_identifier_value",
        "TestErrors.test_label_without_block"])
    + sp.flows(test_acl, [
        "TestPolicyParsing.test_hcl_rules",
        "TestPolicyParsing.test_json_rules_and_validation",
        "TestAuthorizer.test_exact_beats_prefix",
        "TestAuthorizer.test_longest_prefix_wins",
        "TestAuthorizer.test_default_policy",
        "TestAuthorizer.test_deny_precedence_across_policies",
        "TestAuthorizer.test_management_allows_everything",
        "TestGateHardening.test_deny_inside_prefix_blocks_recurse"])
    + sp.flows(test_discovery_chain, [
        "TestCompile.test_default_chain_is_one_resolver",
        "TestCompile.test_splitter_to_subset_resolvers",
        "TestCompile.test_bad_split_weights_rejected",
        "TestCompile.test_router_routes_and_default",
        "TestCompile.test_redirect_followed_cross_dc",
        "TestCompile.test_datacenter_only_redirect",
        "TestCompile.test_failover_targets",
        "TestCompile.test_unknown_subset_rejected",
        "TestCompile.test_redirect_cycle_detected",
        "TestRedirectShapes.test_subset_only_redirect"])
    + sp.flows(test_prepared_query, [
        "TestLogic.test_normalize_defaults_and_validation",
        "TestLogic.test_template_render_name_and_regexp",
        "TestLogic.test_template_remove_empty_tags",
        "TestLogic.test_filter_health_and_ignore",
        "TestLogic.test_filter_tags_and_meta",
        "TestLogic.test_resolve_precedence"])
)


@pytest.mark.parametrize("mod, cls, fn, params", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_policy_matches_reference(monkeypatch, tmp_path, mod, cls, fn,
                                  params):
    sp.assert_same(monkeypatch, mod, cls, fn, params, tmp_path=tmp_path)


def test_health_rollup_matches_reference():
    from consul_tpu.utils import health as jhealth
    from consul_tpu_torch.utils import health as thealth

    statuses = ["passing", "warning", "critical", "maintenance", "", "bogus"]
    for a in statuses:
        assert thealth.severity(a) == jhealth.severity(a)
        for b in statuses:
            assert thealth.worst_status([a, b]) == jhealth.worst_status([a, b])
    assert thealth.worst_status([]) == jhealth.worst_status([])


@pytest.mark.parametrize("case", ["TestCrypto.test_root_and_leaf_verify",
                                  "TestCrypto.test_leaf_san_carries_spiffe_uri"])
def test_connect_ca_matches_reference(monkeypatch, tmp_path, case):
    """Root and leaf: subject, issuer, SPIFFE SAN and CA flag equal, and
    the leaf verifies against its root on both sides."""
    pytest.importorskip("cryptography", reason="the Connect CA mints real "
                        "X.509 material (the reference skips alike)")
    import test_connect_ca

    (_, _, cls, fn, params), = sp.flows(test_connect_ca, [case])
    log = sp.assert_same(monkeypatch, test_connect_ca, cls, fn, params,
                         tmp_path=tmp_path)
    certs = [e[-1]["root_cert"] for e in log if e[0] == "generate_root"]
    assert certs and all(c[0] == "cert" and c[4] is True for c in certs)
