"""PyTorch port vs the JAX reference: the server core
(``consul_tpu_torch/server``: state_store, fsm, raft_store, raft).

- ``StateStore`` / ``FSM``: one command script (catalog, KV with CAS and
  locks, sessions, coordinates, config entries, prepared queries, ACLs,
  intentions, the CA, autopilot, transactions that commit and roll back)
  applied to the reference's and the port's give equal tables, table
  indexes and results;
- ``RaftCluster(seed)`` with ``DurableRaftStore`` under ``tmp_path``:
  one script of proposals, a partition, a crash and a restart from disk
  gives the same terms, roles, votes, leaders, logs and commit indexes at
  every pump, and the same files on disk;
- ``LockstepRaftOracle``: the port's, fed the initial timers and the draw
  tables the reference's oracle drew (as numpy), equals the reference's
  field by field and counter by counter at every tick, with and without
  raft faults (tests/test_torch_raft.py's schedule);
- a blocking query wakes on a write.
"""

import filecmp
import os
import threading
import time

import jax
import numpy as np
import pytest

from consul_tpu.chaos import schedule as jchaos
from consul_tpu.config import RaftConfig as JRaftConfig
from consul_tpu.ops import raft_ops as jraft
from consul_tpu.server import fsm as jfsm
from consul_tpu.server import raft as jraft_host
from consul_tpu.server import raft_store as jraft_store
from consul_tpu.server import state_store as jstate_store
from consul_tpu_torch import chaos as tchaos
from consul_tpu_torch.config import RaftConfig as TRaftConfig
from consul_tpu_torch.server import fsm as tfsm
from consul_tpu_torch.server import raft as traft_host
from consul_tpu_torch.server import raft_store as traft_store
from consul_tpu_torch.server import state_store as tstate_store

SIDES = ((jfsm, jraft_host, jraft_store, jstate_store),
         (tfsm, traft_host, traft_store, tstate_store))


# ----------------------------------------------------------------------
# StateStore and FSM
# ----------------------------------------------------------------------

def script(m):
    """A command script over every FSM message type (``m``: the fsm
    module of one side)."""
    reg = [{"type": m.REGISTER, "node": f"n{i}", "address": f"10.0.0.{i}",
            "node_meta": {"rack": str(i % 2)},
            "service": {"service": "web", "id": f"web{i}", "port": 80 + i,
                        "tags": ["v1"] if i % 2 else []},
            "check": {"check_id": f"c{i}", "status": "passing",
                      "service_id": f"web{i}"}} for i in range(4)]
    return reg + [
        {"type": m.REGISTER, "node": "n1",
         "service": {"service": "db", "port": 5432}},
        {"type": m.KV, "op": "set", "key": "a/b", "value": b"1", "flags": 3},
        {"type": m.KV, "op": "cas", "key": "a/b", "value": b"2",
         "cas_index": 5},
        {"type": m.KV, "op": "cas", "key": "a/b", "value": b"3",
         "cas_index": 999},
        {"type": m.SESSION, "op": "create", "id": "s1", "node": "n0",
         "ttl_s": 10.0},
        {"type": m.KV, "op": "lock", "key": "lk", "value": b"x",
         "session": "s1"},
        {"type": m.KV, "op": "lock", "key": "lk", "value": b"y",
         "session": "s2"},
        {"type": m.KV, "op": "unlock", "key": "lk", "session": "s1"},
        {"type": m.COORDINATE_BATCH_UPDATE, "updates": [
            {"node": "n0", "coord": {"vec": [0.1, 0.2], "height": 1e-5}},
            {"node": "n2", "coord": {"vec": [0.3, 0.4], "height": 2e-5}}]},
        {"type": m.CONFIG_ENTRY, "kind": "service-defaults", "name": "web",
         "entry": {"protocol": "http"}},
        {"type": m.CONFIG_ENTRY, "op": "delete-cas",
         "kind": "service-defaults", "name": "web", "cas_index": 1},
        {"type": m.PREPARED_QUERY, "op": "create",
         "query": {"id": "q1", "name": "geo", "service": "web"}},
        {"type": m.PREPARED_QUERY, "op": "create",
         "query": {"id": "q2", "name": "geo", "service": "db"}},
        {"type": m.ACL, "op": "policy-set",
         "policy": {"name": "ro", "rules": "key \"\" { policy = \"read\" }"}},
        {"type": m.ACL, "op": "bootstrap",
         "token": {"accessor_id": "a1", "secret_id": "s1", "policies": []}},
        {"type": m.ACL, "op": "bootstrap",
         "token": {"accessor_id": "a2", "secret_id": "s2", "policies": []}},
        {"type": m.INTENTION, "op": "create", "intention": {
            "id": "i1", "source": "web", "destination": "db",
            "action": "allow"}},
        {"type": m.CONNECT_CA, "op": "set-root",
         "root": {"id": "r1", "pem": "-----"}},
        {"type": m.AUTOPILOT, "config": {"cleanup_dead_servers": True}},
        {"type": m.TXN, "ops": [
            {"type": m.KV, "op": "set", "key": "t/1", "value": b"a"},
            {"type": m.KV, "op": "set", "key": "t/2", "value": b"b"}]},
        {"type": m.TXN, "ops": [
            {"type": m.KV, "op": "set", "key": "t/3", "value": b"c"},
            {"type": m.KV, "op": "cas", "key": "t/1", "value": b"z",
             "cas_index": 1}]},
        {"type": m.TXN, "ops": [
            {"type": m.KV, "op": "set", "key": "t/4", "value": b"d"},
            {"type": m.KV, "op": "get", "key": "missing"}]},
        {"type": m.KV, "op": "delete-tree", "key": "a/"},
        {"type": m.DEREGISTER, "node": "n3", "check_id": "c3"},
        {"type": m.DEREGISTER, "node": "n3", "service_id": "web3"},
        {"type": m.DEREGISTER, "node": "n2"},
        {"type": m.SESSION, "op": "destroy", "id": "s1"},
    ]


def _apply_script(fsm_mod, store_mod):
    store = store_mod.StateStore()
    fsm = fsm_mod.FSM(store)
    results = []
    for i, cmd in enumerate(script(fsm_mod), start=1):
        try:
            results.append(("ok", fsm.apply(i, cmd)))
        except Exception as e:  # noqa: BLE001 — compared by type
            results.append(("raised", type(e).__name__))
    return store, results


def test_fsm_script_gives_equal_tables():
    (jstore, jres), (tstore, tres) = [_apply_script(f, s)
                                      for f, _, _, s in SIDES]
    assert tres == jres
    assert tstore.snapshot() == jstore.snapshot()
    assert tstore.index == jstore.index
    assert tstore.TABLES == jstore.TABLES
    # Restored from the reference's snapshot, the port reads the same.
    other = tstate_store.StateStore()
    other.restore(jstore.snapshot())
    assert other.snapshot() == jstore.snapshot()
    assert tstore.service_nodes("web") == jstore.service_nodes("web")
    assert tstore.kv_list("t/") == jstore.kv_list("t/")
    assert tstore.node_health("n0") == jstore.node_health("n0")


def test_blocking_query_wakes_on_a_write():
    store = tstate_store.StateStore()
    idx = store.kv_set("k", b"v")[0]
    started = threading.Event()

    def write():
        started.wait(5.0)
        store.kv_set("k", b"w")

    th = threading.Thread(target=write)
    th.start()
    t0 = time.monotonic()
    started.set()
    got_idx, row = store.blocking_query(["kv"], idx,
                                        lambda: store.kv_get("k"),
                                        timeout_s=5.0)
    th.join()
    assert got_idx > idx and row["value"] == b"w"
    assert time.monotonic() - t0 < 5.0
    # No write: the query returns at its (short) timeout.
    t0 = time.monotonic()
    same_idx, _ = store.blocking_query(["kv"], got_idx, lambda: None,
                                       timeout_s=0.05)
    assert same_idx == got_idx and time.monotonic() - t0 >= 0.05


# ----------------------------------------------------------------------
# RaftCluster with durable stores
# ----------------------------------------------------------------------

def _cluster(side, root, seed=7):
    fsm_mod, raft_mod, store_mod, ss_mod = side
    fsms = {}

    def apply_factory(nid):
        fsms[nid] = fsm_mod.FSM(ss_mod.StateStore())
        return fsms[nid].apply

    cluster = raft_mod.RaftCluster(
        5, apply_factory, seed=seed, snapshot_threshold=8,
        snapshot_factory=lambda nid: fsms[nid].snapshot,
        restore_factory=lambda nid: fsms[nid].restore,
        store_factory=lambda nid: store_mod.DurableRaftStore(
            os.path.join(root, nid)))
    return cluster, fsms


def _view(cluster):
    out = {}
    for nid, n in sorted(cluster.nodes.items()):
        out[nid] = (n.term, n.state, n.voted_for, n.leader_id,
                    n.commit_index, n.last_applied, n.log_base_index,
                    n.log_base_term,
                    [(e.term, e.index, e.command) for e in n.log])
    return out


def test_raft_cluster_script_matches_the_reference(tmp_path):
    clusters = [_cluster(side, str(tmp_path / name))
                for side, name in zip(SIDES, ("ref", "port"))]
    pumps = 0

    def pump(rounds=1):
        nonlocal pumps
        for _ in range(rounds):
            for c, _ in clusters:
                c.step()
            pumps += 1
            assert _view(clusters[1][0]) == _view(clusters[0][0]), pumps

    def on_leader(fn):
        out = []
        for c, _ in clusters:
            led = c.leader()
            out.append(None if led is None else fn(c, led))
        assert out[0] == out[1], pumps
        return out[0]

    pump(40)
    assert on_leader(lambda c, led: led.id) is not None
    for i in range(12):  # past the snapshot threshold: compaction
        on_leader(lambda c, led, i=i: led.propose(
            {"type": tfsm.KV, "op": "set", "key": f"k{i}", "value": b"v"}))
        pump(3)
    old = on_leader(lambda c, led: led.id)
    for c, _ in clusters:  # isolate the leader
        for other in c.nodes:
            if other != old:
                c.transport.partition(old, other)
    pump(60)
    on_leader(lambda c, led: led.propose(
        {"type": tfsm.REGISTER, "node": "x", "address": "1.2.3.4"}))
    pump(10)
    for c, _ in clusters:
        c.transport.heal()
    victim = sorted(n for n in clusters[0][0].nodes if n != old)[0]
    for c, _ in clusters:
        c.crash(victim)
    pump(10)
    for c, _ in clusters:
        c.restart_from_disk(victim)
    pump(60)
    view = _view(clusters[1][0])
    assert len({v[4] for v in view.values()}) == 1  # commits converged
    assert max(v[0] for v in view.values()) > 1     # a re-election
    for nid in clusters[0][1]:
        assert clusters[1][1][nid].snapshot() == clusters[0][1][nid].snapshot()
    cmp = filecmp.dircmp(str(tmp_path / "ref"), str(tmp_path / "port"))
    assert sorted(cmp.common_dirs) == sorted(clusters[0][0].nodes)
    for nid in cmp.common_dirs:
        sub = cmp.subdirs[nid]
        assert not sub.left_only and not sub.right_only
        match, mismatch, errors = filecmp.cmpfiles(
            sub.left, sub.right, sub.common_files, shallow=False)
        assert not mismatch and not errors, (nid, mismatch, errors)


# ----------------------------------------------------------------------
# The lockstep oracle of the device raft tier
# ----------------------------------------------------------------------

ELECTION = dict(election_ticks_min=6, election_ticks_max=12)


class _Recorder:
    """The reference's raft_ops as its oracle reads them, keeping every
    draw table it draws (by tick)."""

    chaos_masks_reference = staticmethod(jraft.chaos_masks_reference)

    def __init__(self):
        self.tables = {}

    def draw_table(self, rcfg, base_key, t, *args):
        self.tables[int(t)] = jraft.draw_table(rcfg, base_key, t, *args)
        return self.tables[int(t)]


@pytest.mark.parametrize("shape,chaos", [((2, 3, 16), True),
                                         ((3, 5, 8), False)],
                         ids=["2x3w16-chaos", "3x5w8-quiet"])
def test_lockstep_oracle_matches_the_reference(shape, chaos):
    groups, peers, window = shape
    kw = dict(groups=groups, peers=peers, window=window, **ELECTION)
    jcfg, tcfg = JRaftConfig(**kw), TRaftConfig(**kw)
    base = jax.random.PRNGKey(5)
    init_key = jax.random.fold_in(base, 40961)

    def events(mod):
        if not chaos:
            return []
        return [mod.RaftKill(start=30, stop=44, group=-1, peer=-1),
                mod.RaftPartition(start=48, stop=60, cut=1, group=groups - 1),
                mod.RaftStorm(start=64, stop=72, group=-1)]

    ref = jraft_host.LockstepRaftOracle(jcfg, base, init_key,
                                        events=events(jchaos))
    # The reference oracle's draws, recorded as it takes them.
    ref._rops = _Recorder()
    port = traft_host.LockstepRaftOracle(tcfg, ref.timer.copy(),
                                         ref._rops.tables.__getitem__,
                                         events=events(tchaos))
    bumps = {16: [(0, 3), (groups - 1, window + 4)], 52: [(0, 2)]}
    for t in range(80):
        for g, k in bumps.get(t, ()):
            assert port.bump(g, k) == ref.bump(g, k)
        ref.step(t)
        port.step(t)
        want, got = ref.snapshot(), port.snapshot()
        assert list(got) == list(want)
        for f in want:
            assert got[f].dtype == want[f].dtype, (t, f)
            np.testing.assert_array_equal(got[f], want[f],
                                          err_msg=f"tick {t}: {f}")
        assert port.cnt == ref.cnt, t
    assert port.summary() == ref.summary()
    assert port.cnt["elections_won"] >= groups
    assert port.cnt["commit_advances"] > 0


def test_lockstep_oracle_takes_a_draw_array():
    cfg = TRaftConfig(groups=1, peers=3, window=4, **ELECTION)
    draws = np.full((10, 1, 3), 6, np.int64)
    oracle = traft_host.LockstepRaftOracle(cfg, np.array([[6, 7, 8]]), draws)
    oracle.run(range(10))
    assert oracle.cnt["elections_won"] == 1
    with pytest.raises(ValueError, match="shape"):
        traft_host.LockstepRaftOracle(cfg, np.zeros((2, 3)), draws)
