"""PyTorch port vs the JAX reference: the DCN tier
(``consul_tpu_torch/parallel/dcn.py``): WAN replicas on islands,
reconciled through the host under the link fault envelope.

- bench.py's DCN drill (:641-676): 2 DCs x 64 nodes, 2 servers each,
  ``view_degree=8``, 2 islands, the link from island 0 timing out and the
  link back dropping over sync rounds [1, 4), 192 ticks at
  ``sync_every=16``. Every island starts from the reference island's
  worlds, topologies and state and draws from its key ladder (the
  island's ``base_key`` is the reference's ``fold_in(base_key, k)``,
  dcn.py:149). The reference is its own ``DcnFederation`` (sync, links,
  counters, read-outs) with each island stepped by the reference's tick
  rounded through its packed codec (``torch_parity.fed_oracle``), since
  the port keeps the WAN replicas packed at rest and its floats part from
  a dense f32 replica by more than tests/test_layout_parity.py's
  tolerance within ~64 ticks (the discrete plane never depends on them;
  tests/test_torch_federation.py holds the port against the reference's
  dense runner). After every sync round each island's LAN and WAN states
  equal the reference's (discrete leaves bit for bit, floats within
  ``torch_parity.MAX_STEPS`` storage steps), and the sink's ``sim.dcn.*``
  counters, every link's state (attempt, down_until, degraded,
  queue_peak, queue depth), ``replicas_agree`` and ``wan_status_seen_by``
  equal the reference's.
- Port only: island worlds and initial states equal the single
  federation's slices, and the WAN plant is one across replicas; a bad
  partition raises; a count of ``meshes=`` other than the islands'
  raises (tests/test_torch_fed_mesh.py holds ``meshes=`` to the meshless
  run); a WAN leaf that is not per row raises in ``sync``.
"""

import dataclasses

import jax
import pytest
import torch

from consul_tpu.parallel import dcn as jdcn
from consul_tpu.utils.telemetry import Sink as JSink
from consul_tpu_torch import convert
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import federation as tfed_mod
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.parallel import dcn as tdcn
from consul_tpu_torch.utils.telemetry import Sink as TSink

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

KW = dict(n_dc=2, nodes_per_dc=64, servers_per_dc=2, lan=dict(view_degree=8))
ROUNDS, SYNC_EVERY = 12, 16
COUNTERS = ("retries", "link_down_ticks", "send_timeouts", "retx_dropped",
            "heals", "link_degraded")


def _faults(mod):
    return [mod.LinkFault(src=0, dst=1, start=1, stop=4, kind="timeout"),
            mod.LinkFault(src=1, dst=0, start=1, stop=4)]


@pytest.fixture(scope="module")
def drill():
    """The reference's and the port's drill, round by round; after every
    sync the numpy trees, counters, link states and read-outs of both."""
    jcfg, tcfg = tp.fed_configs(**dict(KW, lan=dict(KW["lan"])))
    jd = jdcn.DcnFederation(jcfg, n_islands=2, seed=0, sink=JSink(),
                            link_policy=jdcn.LinkPolicy(retry_max=3,
                                                        queue_bound=4))
    td = tdcn.DcnFederation(tcfg, n_islands=2, seed=0, sink=TSink(),
                            link_policy=tdcn.LinkPolicy(retry_max=3,
                                                        queue_bound=4),
                            device="cpu", kernel="torch")
    # Each island starts from the reference island's worlds, topologies and
    # state and draws from its key ladder.
    td.islands = [tp.port_federation(j.cfg, t.cfg, j)
                  for j, t in zip(jd.islands, td.islands)]
    jd.inject_link_faults(_faults(jdcn))
    td.inject_link_faults(_faults(tdcn))

    def view(d, sink):
        return dict(
            counters={c: sink.counter_sum("sim.dcn." + c) for c in COUNTERS},
            links={ab: (ls.attempt, ls.down_until, ls.degraded, ls.queue_peak,
                        len(ls.queue))
                   for ab, ls in d._links.items()},
            agree=d.replicas_agree(), peak=d.queue_peak(),
            seen=[d.wan_status_seen_by(o, s) for o in range(2)
                  for s in range(2)])

    oracle = tp.fed_oracle(jd.islands[0].cfg, jd.islands[0].lan_topo,
                           jd.islands[0].wan_topo)
    for jisl in jd.islands:
        jisl.state = oracle.start(jisl.state)
    rounds = []
    for _ in range(ROUNDS):
        for jisl, tisl in zip(jd.islands, td.islands):
            for t in range(tisl._t, tisl._t + SYNC_EVERY):
                key = jax.random.fold_in(jisl.base_key, t)
                jisl.state = oracle(jisl.lan_world, jisl.wan_world, jisl.state,
                                    key, jisl._wan_off)[0]
            tisl.run(SYNC_EVERY, chunk=SYNC_EVERY)
        jd.sync(ticks=SYNC_EVERY)
        td.sync(ticks=SYNC_EVERY)
        rounds.append(([tp.np_tree(i.state) for i in jd.islands],
                       [i.state for i in td.islands],
                       view(jd, jd.sink), view(td, td.sink)))
    return jd, td, rounds


def test_islands_match_reference_after_every_sync(drill):
    _, _, rounds = drill
    for r, (ref, got, _, _) in enumerate(rounds):
        for k, (rs, gs) in enumerate(zip(ref, got)):
            tp.assert_fed_close(rs, gs, f"round {r} island {k}")


def test_link_envelope_matches_reference(drill):
    jd, td, rounds = drill
    for r, (_, _, want, got) in enumerate(rounds):
        assert got == want, f"round {r}"
    final = rounds[-1][3]
    # bench.py's drill: the links retried, timed out, dropped payloads,
    # healed, and the replicas agree again within the queue bound.
    assert final["counters"]["heals"] == 2 and final["counters"]["retries"] > 0
    assert final["counters"]["send_timeouts"] > 0
    assert final["agree"] and final["peak"] <= td.link_policy.queue_bound
    assert not rounds[2][3]["agree"]
    assert td.queue_peak() == jd.queue_peak()


def _small(n_dc=4):
    return tfed_mod.FederationConfig(n_dc=n_dc, nodes_per_dc=32,
                                     servers_per_dc=3,
                                     lan=TSimConfig(view_degree=8))


def _bits(x):
    return x.reshape(-1).view(torch.uint8) if x.dim() else x


def test_island_worlds_match_single_federation_slices():
    cfg = _small()
    single = tfed_mod.Federation(cfg, seed=5, device="cpu", kernel="torch")
    d = tdcn.DcnFederation(cfg, n_islands=2, seed=5, device="cpu",
                           kernel="torch")
    for k, isl in enumerate(d.islands):
        for i in range(2):
            a, b = isl.lan_world[i], single.lan_world[2 * k + i]
            assert torch.equal(a.pos, b.pos) and torch.equal(a.height, b.height)
            for x, y in zip(tlayout.leaves(isl.state.lan[i]),
                            tlayout.leaves(single.state.lan[2 * k + i])):
                assert torch.equal(_bits(x), _bits(y))
        assert torch.equal(isl.wan_world.pos, single.wan_world.pos)
        assert isl.wan_topo.off_host == single.wan_topo.off_host
        assert isl.lan_topo.off_host == single.lan_topo.off_host
    # Each replica draws from a stream of its own.
    a, b = d.islands[0].gen.get_state(), d.islands[1].gen.get_state()
    assert not torch.equal(a, b)
    assert not torch.equal(a, single.gen.get_state())


def test_bad_partition_and_meshes_raise():
    with pytest.raises(ValueError, match="divide"):
        tdcn.DcnFederation(_small(n_dc=3), n_islands=2, device="cpu",
                           kernel="torch")
    with pytest.raises(ValueError, match="3 meshes for 2 islands"):
        tdcn.DcnFederation(_small(), n_islands=2,
                           meshes=[["cpu"] * 2] * 3, device="cpu",
                           kernel="torch")


def test_sync_merges_owned_rows_and_rejects_a_leaf_not_per_row():
    cfg = dataclasses.replace(_small(), nodes_per_dc=16)
    d = tdcn.DcnFederation(cfg, n_islands=2, seed=1, device="cpu",
                           kernel="torch")
    d.run(8, sync_every=4)
    assert d.replicas_agree()
    # Each replica's own rows are its own; the other island's came across.
    for isl in d.islands:
        assert torch.equal(_bits(isl.state.wan.viv.vec),
                           _bits(d.islands[0].state.wan.viv.vec))
    for isl in d.islands:
        w = isl.state.wan
        isl.state = isl.state._replace(wan=w._replace(own_inc=w.own_inc[:1]))
    with pytest.raises(ValueError, match="per-row WAN leaf own_inc"):
        d.sync()
