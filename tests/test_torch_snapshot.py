"""PyTorch port vs the JAX reference: the serf snapshotter
(``models/snapshot.py``) and the event coalescer (``models/coalesce.py``).

- The log a port ``Snapshotter`` writes is byte-equal to the reference's
  for the same observation sequence (reference states at n = 64, K = 16,
  carried across with ``convert.py``, observed dense and packed; a
  neighbor's death and the clocks moving in between); compaction inside
  ``observe`` keeps the same bytes on both sides.
- ``replay`` equals the reference's on the logs above and on torn,
  corrupt and truncated tails, with and without ``rejoin_after_leave``.
- ``rejoin`` (warm, and the cold fallback of an empty replay) equals the
  reference's on the same state, leaf for leaf.
- Compaction bounds the file, a reopened log primes from it, a leftover
  ``.compact`` file is ignored and overwritten, a crash inside
  ``compact`` leaves the log valid (reference tests/test_snapshot.py).
- On the port alone, a warm rejoin re-converges in fewer ticks than a cold
  restart (reference tests/test_snapshot.py:124), through
  ``SerfSimulation.rejoin``.
- The coalescer's flushes equal the reference's on the same seeded event
  streams.
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consul_tpu.config import GossipConfig as JGossipConfig
from consul_tpu.config import SimConfig as JSimConfig
from consul_tpu.models import coalesce as jco
from consul_tpu.models import layout as jlayout
from consul_tpu.models import serf as jserf
from consul_tpu.models import snapshot as jsnap
from consul_tpu.models import state as jstate
from consul_tpu.ops import topology as jtopo
from consul_tpu_torch import convert
from consul_tpu_torch.config import GossipConfig as TGossipConfig
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.models import cluster as tcluster
from consul_tpu_torch.models import coalesce as tco
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.models import snapshot as tsnap
from consul_tpu_torch.ops import merge

import torch_parity as tp
from torch_parity import quick_reference_compiles  # noqa: F401

N = 64
NODE = 10
_WORLD = {}


def _world():
    """tests/test_snapshot.py's world (PRNGKey(2), K = 16, LAN push-pull at
    6 s) and a jitted reference step, once per module."""
    if not _WORLD:
        g = dict(push_pull_interval_ms=6_000)
        jcfg = JSimConfig(n=N, view_degree=16, gossip=JGossipConfig.lan(**g))
        tcfg = TSimConfig(n=N, view_degree=16, gossip=TGossipConfig.lan(**g))
        kw, kn, ks = jax.random.split(jax.random.PRNGKey(2), 3)
        world = jtopo.make_world(jcfg, kw)
        topo = jtopo.make_topology(jcfg, kn)
        step = jax.jit(lambda st, k: jserf.step(jcfg, topo, world, st, k))
        _WORLD.update(jcfg=jcfg, tcfg=tcfg, world=world, topo=topo,
                      state=jserf.init(jcfg, ks), step=step,
                      ttopo=convert.topology_from(tp.np_tree(topo)))
    return _WORLD


def _run(state, step, ticks, seed=0):
    base = jax.random.PRNGKey(seed)
    for i in range(ticks):
        state = step(state, jax.random.fold_in(base, i))
    return state


def _observations():
    """Reference states to observe: formed, a neighbor dead (and an event
    fired by the seat), more ticks."""
    w = _world()
    if "obs" not in w:
        st = _run(w["state"], w["step"], 40)
        states = [w["state"], st]
        victim = int(jtopo.nbrs_table(w["topo"])[NODE, 0])
        st = st._replace(swim=jstate.kill(st.swim, jnp.arange(N) == victim))
        st = jserf.user_event(w["jcfg"], st, jnp.arange(N) == NODE, 5)
        st = _run(st, w["step"], 250, seed=1)
        states.append(st)
        states.append(_run(st, w["step"], 20, seed=2))
        w["obs"] = states
    return w["obs"]


def _port_state(st, packed=False):
    if packed:
        return convert.serf_state_from(tp.np_tree(jlayout.pack_state(st)))
    return convert.serf_state_from(tp.np_tree(st))


@pytest.mark.parametrize("compact,packed", [(128 * 1024, False), (128 * 1024, True),
                                            (120, False)],
                         ids=["dense", "packed", "compacting"])
def test_log_bytes_equal_reference(tmp_path, compact, packed):
    w = _world()
    jp, tp_ = str(tmp_path / "ref"), str(tmp_path / "port")
    js = jsnap.Snapshotter(jp, NODE, min_compact_size=compact)
    ts = tsnap.Snapshotter(tp_, NODE, min_compact_size=compact)
    for st in _observations():
        js.observe(w["jcfg"], w["topo"], st)
        ts.observe(w["tcfg"], w["ttopo"], _port_state(st, packed))
        assert ts.offset == js.offset
    js.leave()
    ts.leave()
    js.close()
    ts.close()
    ref = open(jp, "rb").read()
    assert open(tp_, "rb").read() == ref
    assert b"not-alive: sim-" in ref or compact < 1024
    for rejoin_after_leave in (False, True):
        a = jsnap.replay(jp, rejoin_after_leave)
        b = tsnap.replay(tp_, rejoin_after_leave)
        assert vars(a) == vars(b)


@pytest.mark.parametrize("text", [
    "alive: sim-3 sim-3:7946\nclock: 9\nclock: 1",
    "alive: sim-3 sim-3:7946\nclock: 9\nclock: 1x2\nevent-clock: 4\x00\n"
    "garbage line with no known prefix\n",
    "alive: sim-1 sim-1:7946\nalive: sim-2",
    "alive: sim-1 sim-1:7946\nleave\nalive: sim-4 sim-4:7946\nquery-clock: 3\n",
    "alive: sim-1 sim-1:7946\nnot-alive: sim-1\nevent-clock: 12\nleave\n",
], ids=["torn", "corrupt", "truncated-alive", "leave-then-alive", "leave-last"])
def test_replay_equal_reference(tmp_path, text):
    p = str(tmp_path / "s")
    with open(p, "w") as f:
        f.write(text)
    for rejoin_after_leave in (False, True):
        assert vars(tsnap.replay(p, rejoin_after_leave)) == vars(
            jsnap.replay(p, rejoin_after_leave))
    assert vars(tsnap.replay(str(tmp_path / "missing"))) == vars(
        jsnap.replay(str(tmp_path / "missing")))


@pytest.mark.parametrize("which", ["warm", "dropped", "empty"])
def test_rejoin_equals_reference(tmp_path, which):
    w = _world()
    st = _observations()[1]
    p = str(tmp_path / "s")
    if which != "empty":
        snap = jsnap.Snapshotter(p, NODE)
        snap.observe(w["jcfg"], w["topo"], st)
        snap.close()
    rep = jsnap.replay(p)
    if which == "dropped":
        del rep.alive[sorted(rep.alive)[0]]
    crashed = st._replace(swim=jstate.kill(st.swim, jnp.arange(N) == NODE))
    ref = jsnap.rejoin(w["jcfg"], w["topo"], crashed, NODE, rep)
    got = tsnap.rejoin(w["tcfg"], w["ttopo"], _port_state(crashed), NODE,
                       tsnap.replay(p) if which != "dropped" else rep)
    r = tp.np_tree(ref)
    tp.assert_serf_equal(r, got, which)
    tp.assert_state_matches(r.swim, got.swim, which)
    row = got.swim.view_key[NODE]
    seeds = int((row == merge.make_key_int(0, merge.ALIVE)).sum())
    assert seeds == {"warm": 16, "dropped": 15, "empty": 4}[which]


def test_compaction_reopen_and_leftovers(tmp_path, monkeypatch):
    w = _world()
    st = _observations()[0]
    # Compaction bounds the file under churn.
    p = str(tmp_path / "s")
    snap = tsnap.Snapshotter(p, NODE, min_compact_size=600)
    for i in range(60):
        if i % 2:
            snap._last_alive.pop("sim-11", None)
        else:
            snap._last_alive.update({"sim-11": "sim-11:7946"})
        snap._append("alive: sim-11 sim-11:7946\n" if i % 2 == 0
                     else "not-alive: sim-11\n")
    assert snap.offset <= 640
    snap.close()
    # Compaction inside observe keeps the lines just logged.
    p2 = str(tmp_path / "s2")
    snap = tsnap.Snapshotter(p2, NODE, min_compact_size=60)
    snap.observe(w["tcfg"], w["ttopo"], _port_state(st))
    assert len(tsnap.replay(p2).alive) == 16
    size1 = snap.offset
    snap.close()
    # A reopened log primes from the file: only the death appends.
    later = _observations()[2]
    snap = tsnap.Snapshotter(p2, NODE, min_compact_size=60 * 1024)
    assert snap._last_alive
    snap.observe(w["tcfg"], w["ttopo"], _port_state(later))
    assert 0 < snap.offset - size1 < 80
    snap.close()
    # A leftover .compact from a crash is ignored, then overwritten.
    p3 = str(tmp_path / "s3")
    with open(p3, "w") as f:
        f.write("alive: sim-5 sim-5:7946\nclock: 7\n")
    with open(p3 + ".compact", "w") as f:
        f.write("alive: sim-99 sim-99:7946\nclock: 999\n")
    rep = tsnap.replay(p3)
    assert rep.alive == {"sim-5": "sim-5:7946"} and rep.clock == 7
    snap = tsnap.Snapshotter(p3, NODE)
    snap.compact()
    snap.close()
    assert vars(tsnap.replay(p3)) == vars(rep)
    assert not os.path.exists(p3 + ".compact")
    # A crash inside compact leaves the log valid.
    snap = tsnap.Snapshotter(p3, NODE)
    before = tsnap.replay(p3).alive

    def boom(src, dst):
        raise OSError("crash before rename")

    monkeypatch.setattr(tsnap.os, "replace", boom)
    with pytest.raises(OSError):
        snap.compact()
    monkeypatch.undo()
    assert tsnap.replay(p3).alive == before


def test_warm_rejoin_faster_than_cold(tmp_path):
    """tests/test_snapshot.py:124 through the port's SerfSimulation: the
    seat is observed every chunk, killed, and rejoined warm and cold from
    the same state; the warm one sees its whole view alive sooner."""
    cfg = TSimConfig(n=N, view_degree=16,
                     gossip=TGossipConfig.lan(push_pull_interval_ms=6_000))
    p = str(tmp_path / "serf.snapshot")
    sim = tcluster.SerfSimulation(cfg, seed=2, device="cpu", kernel="torch")
    snap = tsnap.Snapshotter(p, NODE)
    for _ in range(5):
        sim.run(8, chunk=8, with_metrics=False)
        snap.observe(cfg, sim.topo, sim.state)
    snap.close()
    rep = tsnap.replay(p)
    assert len(rep.alive) == cfg.degree
    sim.kill(torch.arange(N) == NODE)
    sim.run(200, chunk=50, with_metrics=False)
    crashed = tcluster._clone(sim.state)
    gen = sim.gen.get_state()

    def ticks_to_full_view(limit=400):
        for i in range(limit):
            sim.run(1, chunk=1, with_metrics=False)
            st = sim.serf_state
            if bool(((st.swim.view_key[NODE] & 3) == merge.ALIVE).all()) and \
                    bool(st.swim.alive_truth.all()):
                return i + 1
        return limit + 1

    sim.revive(torch.arange(N) == NODE, cold=True)
    cold = ticks_to_full_view()
    sim.load_state(crashed)
    sim.gen.set_state(gen)
    sim.rejoin(NODE, rep)
    assert int(sim.serf_state.clock[NODE]) >= rep.clock
    warm = ticks_to_full_view()
    assert warm < cold, (warm, cold)


def _stream(mod, seed):
    """A seeded burst of member and user events over 60 ticks."""
    rng = random.Random(seed)
    types = [mod.MEMBER_JOIN, mod.MEMBER_LEAVE, mod.MEMBER_FAILED,
             mod.MEMBER_UPDATE, mod.MEMBER_REAP, mod.USER]
    out = []
    for t in range(60):
        for _ in range(rng.randrange(4)):
            ty = rng.choice(types)
            out.append((t, mod.Event(type=ty, name=f"n{rng.randrange(6)}",
                                     ltime=rng.randrange(5),
                                     coalesce=rng.random() < 0.8)))
    return out


def _flat(events):
    return [(e.type, e.name, e.ltime, e.payload, e.coalesce) for e in events]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coalescer_equals_reference(seed):
    log = {}
    for mod in (jco, tco):
        pipe = mod.CoalescePipeline(coalesce_period=5, quiescent_period=2,
                                    user_coalesce_period=4,
                                    user_quiescent_period=1)
        out, events = [], iter(_stream(mod, seed))
        pending = next(events, None)
        for t in range(70):
            while pending is not None and pending[0] == t:
                out.append(("in", t, _flat(pipe.ingest(pending[1], t))))
                pending = next(events, None)
            out.append(("tick", t, _flat(pipe.tick(t))))
        log[mod] = out
    assert log[tco] == log[jco]
    assert any(x[2] for x in log[tco] if x[0] == "tick")
