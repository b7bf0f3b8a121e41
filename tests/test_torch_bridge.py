"""PyTorch port vs the JAX reference: the transport seam
(``consul_tpu_torch/wire/bridge.py``) with scripted agents attached.

One numpy-only scripted agent class (:class:`ScriptedAgent`, defined
here: the reference's own test agent draws with ``jax.random``) drives
the reference's ``PacketBridge`` over the reference's ``Simulation`` /
``SerfSimulation`` and the port's over the port's, with the same inputs.
The port's simulations start from the reference's world, topology and
state (``convert.py``) and draw from its key ladder
(``torch_parity.make_draws_fn`` / ``make_serf_draws_fn``). Each flow runs
three sides in lockstep: the reference (dense), the port on the plain
tick with ``layout="dense"``, and the port with ``layout="packed"``.
After every step:

- the port's dense state equals the reference's: the discrete plane bit
  for bit, the floats within ``torch_parity``'s tolerance
  (``assert_state_matches``; the serf leaves ``assert_serf_equal``);
- the packed run's discrete plane equals the dense run's, its floats
  within the packed codec's tolerance (tests/test_layout_parity.py's);
- every packet delivered to every agent is byte-equal on the three sides,
  except an ack carrying a coordinate, compared decoded with the floats
  within the same tolerances; every timestamp is within them too.

The SWIM flow (a ``Simulation``, n = 128, K = 16, suspicion timeouts
cut as in tests/test_torch_cluster.py): a name conflict refused by the
trackers' majority; SEAT's process restarted as an agent at once (an
operator takeover at incarnation 2) that joins by push-pull, learns its
neighbourhood and is believed alive; garbage dropped; HOLDER killed
and, once its trackers hold it dead, its seat taken without
``replace``; the agent's shutdown detected; a second attach refused.
The serf flow (a ``SerfSimulation``, n = 64, K = 16,
tests/test_bridge_serf.py's shape): events and queries both ways, the
tallies and per-responder records, the name registry and its LRU
eviction, a malformed envelope dropped. Tick counts are cut from the
reference's tests (400 bridged ticks at n = 1,024 there) to keep the
file's budget: most of its cost is the reference compiling its two
simulation runners. Each flow's counts are the constants below.

Two more flows run on the port's side only, with the reference tests'
timeouts and tick counts, and assert the reference tests' own outcomes
there (tests/test_bridge.py:206-267, tests/test_bridge_scale.py:88-139).
The agent flow (a packed ``Simulation`` at this file's n = 128, K = 16,
where the reference runs n = 1,024, K = 32; the default timeouts, 400
bridged ticks as there): SEAT killed and detected; an agent at incarnation 2
rejoins through the bridge and runs 400 bridged ticks; every live
in-neighbour then believes it alive at incarnation >= 2, ``metrics.health``
counts no false positive and nothing undetected, the agent's coordinate
RMSE to its probed peers is under 15 ms over at least 30 RTTs, and the
seat's mirrored row is non-zero and within 5 ms of the agent's
coordinate; after the agent's shutdown and ``run_until_converged`` every
live in-neighbour holds it dead or left. The fleet flow (a packed
``SerfSimulation``, n = 256, K = 16, 32 agents): the agents stay alive
under probing and no sampled observer sees one dead; an agent's event
reaches every live simulated node and 3/4 of the other agents; a
simulated query collects ``responses_total >= N - 32 - 2`` with 3/4 of the
agents answering. (The reference's timing ratio, tests/test_bridge_scale.py:
140-165, is measured on the card: ``chip_smoke.py``'s ``bridge_main_path``.)
"""

import jax
import numpy as np
import pytest
import torch

from consul_tpu.models.cluster import SerfSimulation as JSerfSimulation
from consul_tpu.models.cluster import Simulation as JSimulation
from consul_tpu.wire import bridge as jbridge
from consul_tpu_torch import convert
from consul_tpu_torch.models import layout as tlayout
from consul_tpu_torch.models.cluster import SerfSimulation as TSerfSimulation
from consul_tpu_torch.models.cluster import Simulation as TSimulation
from consul_tpu_torch.ops import merge
from consul_tpu_torch.wire import bridge as tbridge
from consul_tpu_torch.wire import codec
from consul_tpu_torch.wire.codec import MessageType

import torch_parity as tp
from consul_tpu_torch.config import SimConfig as TSimConfig
from consul_tpu_torch.ops import topology as ttopology
from consul_tpu_torch.ops import vivaldi as tvivaldi
from consul_tpu_torch.utils import metrics as tmetrics
from torch_parity import quick_reference_compiles  # noqa: F401

GOSSIP = dict(suspicion_mult=2, suspicion_max_timeout_mult=2)

N = 128
SEAT = 50
HOLDER = 90
JOIN_TICKS = 64        # bridged ticks with the agent joined
DOWN_TICKS = 32        # after the agent's shutdown

SERF_N = 64
SERF_SEAT = 20
SERF_FORM = 8


# ----------------------------------------------------------------------
# The scripted agent (numpy only)
# ----------------------------------------------------------------------

class ScriptedAgent:
    """A serial memberlist/serf client: answers pings with its coordinate,
    probes a random alive member once per probe interval, gossips its own
    aliveness, learns members from gossip and push-pull, updates a scalar
    Vivaldi coordinate (float64 numpy) from probe RTTs, and answers serf
    queries with an ack and a response. Every packet it receives is kept
    in ``log`` as ``(buf, from_addr, timestamp)``."""

    def __init__(self, transport, cfg, incarnation=1, seed=0):
        self.t = transport
        self.cfg = cfg
        self.name, _ = transport.final_advertise_addr()
        self.inc = incarnation
        self.members = {}
        v = cfg.vivaldi
        self.vec = np.zeros(v.dimensionality)
        self.height = v.height_min
        self.error = v.vivaldi_error_max
        self.pending = {}
        self.seq = 0
        self.rng = np.random.default_rng(seed)
        self.rtt_log = []
        self.log = []
        self.events_seen = []
        self.queries_answered = []
        self._next_probe = None

    def coordinate(self) -> bytes:
        return tbridge.encode_coordinate(self.vec, self.height, self.error, 0.0)

    def _merge(self, name, inc, state):
        if name == self.name:
            if state != tbridge.WIRE_ALIVE and inc >= self.inc:
                self.inc = inc + 1
            return
        cur = self.members.get(name)
        if cur is None or (inc, state) > cur:
            self.members[name] = (inc, state)

    def alive_members(self):
        return sorted(n for n, (_, s) in self.members.items()
                      if s == tbridge.WIRE_ALIVE)

    def start_join(self, addr):
        self._join = self.t.dial_timeout(addr)
        me = {"Name": self.name, "Addr": self.name.encode(), "Port": 7946,
              "Meta": b"", "Incarnation": self.inc,
              "State": tbridge.WIRE_ALIVE, "Vsn": [1, 5, 1, 2, 5, 4]}
        self._join.send(codec.encode_stream_frame(
            codec.encode_push_pull([me], join=True), None))

    def finish_join(self):
        _, states, _ = codec.decode_push_pull(
            codec.decode_stream_frame(self._join.recv(timeout=1.0), None))
        for s in states:
            self._merge(s["Name"], s["Incarnation"], s["State"])

    def _viv(self, other, rtt):
        v = self.cfg.vivaldi
        ovec = np.asarray(other["Vec"], np.float64)
        diff = self.vec - ovec
        norm = float(np.sqrt(diff @ diff))
        dist = norm + self.height + other["Height"]
        total = max(self.error + other["Error"], 1e-6)
        weight = self.error / total
        wrong = abs(dist - rtt) / rtt
        self.error = min(v.vivaldi_error_max, v.vivaldi_ce * weight * wrong
                         + self.error * (1 - v.vivaldi_ce * weight))
        force = v.vivaldi_cc * weight * (rtt - dist)
        if norm > 1e-9:
            unit = diff / norm
        else:
            unit = self.rng.uniform(-0.5, 0.5, diff.shape)
            unit /= np.sqrt(unit @ unit)
        self.vec = self.vec + unit * force
        if norm > 1e-9:
            self.height = max(v.height_min, self.height
                              + (self.height + other["Height"]) * force / dist)

    def tick(self, now):
        while not self.t.packet_ch.empty():
            pkt = self.t.packet_ch.get()
            self.log.append((pkt.buf, pkt.from_addr, pkt.timestamp))
            try:
                msgs = codec.decode_packet(pkt.buf)
            except ValueError:
                continue
            for mtype, body in msgs:
                self._handle(mtype, body, pkt)
        g = self.cfg.gossip
        for seq in [s for s, (ts, _) in self.pending.items()
                    if now - ts > 4 * g.probe_timeout_ms / 1000.0]:
            del self.pending[seq]
        if self._next_probe is None:
            self._next_probe = now
        if now < self._next_probe:
            return
        self._next_probe = now + g.probe_interval_ms / 1000.0
        alive = self.alive_members()
        if not alive:
            return
        peer = alive[self.rng.integers(len(alive))]
        self.seq += 1
        ping = codec.encode_message(MessageType.PING,
                                    {"SeqNo": self.seq, "Node": peer})
        self.pending[self.seq] = (self.t.write_to(codec.encode_packet([ping]),
                                                  peer + ":7946"), peer)
        for _ in range(g.gossip_nodes):
            tgt = alive[self.rng.integers(len(alive))]
            msg = codec.encode_message(MessageType.ALIVE, {
                "Incarnation": self.inc, "Node": self.name,
                "Addr": self.name.encode(), "Port": 7946, "Meta": b"",
                "Vsn": [1, 5, 1, 2, 5, 4]})
            self.t.write_to(codec.encode_packet([msg]), tgt + ":7946")

    def _handle(self, mtype, body, pkt):
        if mtype == MessageType.PING:
            ack = codec.encode_message(MessageType.ACK_RESP, {
                "SeqNo": body["SeqNo"], "Payload": self.coordinate()})
            self.t.write_to(codec.encode_packet([ack]), pkt.from_addr)
        elif mtype == MessageType.ACK_RESP:
            pend = self.pending.pop(body["SeqNo"], None)
            coord = tbridge.decode_coordinate(body.get("Payload", b""))
            if pend is None or coord is None:
                return
            rtt = pkt.timestamp - pend[0]
            if rtt > 0:
                self.rtt_log.append((pend[1], rtt))
                self._viv(coord, rtt)
        elif mtype in (MessageType.ALIVE, MessageType.SUSPECT,
                       MessageType.DEAD):
            self._merge(body["Node"], body["Incarnation"],
                        {MessageType.ALIVE: tbridge.WIRE_ALIVE,
                         MessageType.SUSPECT: tbridge.WIRE_SUSPECT,
                         MessageType.DEAD: tbridge.WIRE_DEAD}[mtype])
        elif mtype == MessageType.USER:
            stype, sbody = codec.decode_serf_message(body["Raw"])
            if stype == codec.SERF_USER_EVENT:
                self.events_seen.append(str(sbody["Name"]))
            elif stype == codec.SERF_QUERY:
                qid = int(sbody["ID"])
                if qid in self.queries_answered:
                    return
                self.queries_answered.append(qid)
                origin = codec.as_bytes(sbody["Addr"]).decode()
                for flags, payload in ((1, b""), (0, self.name.encode())):
                    msg = codec.encode_serf_message(
                        codec.SERF_QUERY_RESPONSE, {
                            "LTime": sbody["LTime"], "ID": qid,
                            "From": self.name, "Flags": flags,
                            "Payload": payload})
                    self.t.write_to(codec.encode_packet([msg]),
                                    origin + ":7946")


# ----------------------------------------------------------------------
# Lockstep harness
# ----------------------------------------------------------------------

class Side:
    def __init__(self, sim, bridge_mod):
        self.sim = sim
        self.br = bridge_mod.PacketBridge(sim)
        self.agents = {}

    def swim(self):
        """The dense SWIM plane as numpy (reference) or tensors (port)."""
        st = self.sim.state
        st = st.swim if hasattr(st, "swim") else st
        if isinstance(self.sim, JSimulation):
            return tp.np_tree(st)
        return tlayout.unpack(st) if isinstance(st, tlayout.PackedSimState) \
            else st

    def step(self, ticks=1):
        for _ in range(ticks):
            self.sim.run(1, chunk=1, with_metrics=False)
            self.br.step()
            for a in self.agents.values():
                a.tick(self.br.now())


def make_sides(jsim, tcfg, cls, draws_fn, to_draws, state_from):
    """The reference side and the port's dense and packed sides, started
    from the reference simulation's world, topology and state."""
    cache = {}

    def draws(t):
        if t not in cache:
            cache.clear()
            cache[t] = draws_fn(jax.random.fold_in(jsim.base_key, t))
        return to_draws(cache[t])

    sides = [Side(jsim, jbridge)]
    for lay in ("dense", "packed"):
        sides.append(Side(cls(
            tcfg, seed=0, layout=lay, kernel="torch", device="cpu",
            world=convert.world_from(tp.np_tree(jsim.world)),
            topo=convert.topology_from(tp.np_tree(jsim.topo)),
            state=state_from(tp.np_tree(jsim.state)), draws=draws),
            tbridge))
    return sides


def _coord(buf):
    """The decoded coordinate of an ack packet, or None."""
    try:
        msgs = codec.decode_packet(buf)
    except ValueError:
        return None
    if len(msgs) == 1 and msgs[0][0] == MessageType.ACK_RESP \
            and msgs[0][1].get("Payload"):
        return msgs[0][1]["SeqNo"], tbridge.decode_coordinate(
            msgs[0][1]["Payload"])
    return None


# The packed run's floats against the dense run's, in seconds (error:
# unitless): the packed codec rounds the coordinates through bfloat16 and
# the RTT windows through scaled float8 every tick, and the two
# trajectories drift apart a little more each tick; these bounds are ~3x
# the largest drift measured over these flows (vec 0.73 ms, height
# 0.056 ms, adjustment 0.27 ms, error 0.036, RTT windows 4.1 ms).
PACKED_DRIFT = {"vec": 2.5e-3, "height": 2.5e-4, "adjustment": 1e-3,
                "error": 0.12, "adj_samples": 2e-2, "lat_buf": 2e-2}


def assert_packets(ref_log, got_log, drift, where, start=0):
    """Packet logs equal from entry ``start`` on: byte for byte, except
    acks carrying a coordinate, whose floats are held to ``tp.VIV_RTOL`` /
    ``VIV_ATOL`` (``drift`` None) or to the ``drift`` bounds."""
    assert len(got_log) == len(ref_log), (where, len(got_log), len(ref_log))
    for i, ((rb, ra, rt), (gb, ga, gt)) in enumerate(
            zip(ref_log[start:], got_log[start:]), start):
        assert ga == ra, (where, i)
        np.testing.assert_allclose(gt, rt, rtol=1e-6, err_msg=f"{where} #{i}")
        if gb == rb:
            continue
        rc, gc = _coord(rb), _coord(gb)
        assert rc is not None and gc is not None, (where, i, rb, gb)
        assert rc[0] == gc[0], (where, i)
        for k, f in (("Vec", "vec"), ("Height", "height"), ("Error", "error"),
                     ("Adjustment", "adjustment")):
            tol = (dict(rtol=tp.VIV_RTOL, atol=tp.VIV_ATOL) if drift is None
                   else dict(rtol=0, atol=drift[f]))
            np.testing.assert_allclose(gc[1][k], rc[1][k], **tol,
                                       err_msg=f"{where} #{i} {k}")


DISCRETE_VIV = ("adj_idx", "resets")


def assert_packed_agrees(dense, packed, where):
    """The packed run against the dense run of the port: the discrete plane
    bit for bit, the floats within PACKED_DRIFT."""
    for f in tp.DISCRETE:
        assert torch.equal(getattr(packed, f), getattr(dense, f)), (where, f)
    for f in DISCRETE_VIV:
        assert torch.equal(getattr(packed.viv, f), getattr(dense.viv, f)), \
            (where, f)
    for f in ("vec", "height", "error", "adjustment", "adj_samples"):
        np.testing.assert_allclose(
            getattr(packed.viv, f).numpy(), getattr(dense.viv, f).numpy(),
            rtol=0, atol=PACKED_DRIFT[f], err_msg=f"{where}: viv.{f}")
    np.testing.assert_allclose(packed.lat_buf.numpy(), dense.lat_buf.numpy(),
                               rtol=0, atol=PACKED_DRIFT["lat_buf"],
                               err_msg=f"{where}: lat_buf")


def check(sides, where):
    ref, dense, packed = sides
    tp.assert_state_matches(ref.swim(), dense.swim(), where)
    assert_packed_agrees(dense.swim(), packed.swim(), where)
    if hasattr(ref.sim.state, "swim"):
        tp.assert_serf_equal(tp.np_tree(ref.sim.state), dense.sim.state, where)
        tp.assert_serf_equal(tp.np_tree(ref.sim.state), packed.sim.state,
                             where)
    for seat, agent in ref.agents.items():
        start = getattr(agent, "checked", 0)
        assert_packets(agent.log, dense.agents[seat].log, None,
                       f"{where} dense seat {seat}", start)
        assert_packets(agent.log, packed.agents[seat].log, PACKED_DRIFT,
                       f"{where} packed seat {seat}", start)
        agent.checked = len(agent.log)


def lockstep(sides, ticks, where):
    for i in range(ticks):
        for s in sides:
            s.step()
        check(sides, f"{where} +{i + 1}")


def beliefs(sim_dense, seat, off):
    """Each live tracker's belief about ``seat``: (incarnation, status)."""
    out = []
    n = sim_dense.alive_truth.shape[0]
    for j in range(off.shape[0]):
        r = (seat - int(off[j])) % n
        if bool(sim_dense.alive_truth[r]):
            key = int(sim_dense.view_key[r, j])
            out.append((key >> 2, key & 3))
    return out


def majority(b, pred) -> bool:
    return bool(b) and 2 * sum(1 for x in b if pred(*x)) > len(b)


# ----------------------------------------------------------------------
# The SWIM flow
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def swim_flow(tmp_path_factory):
    return tp.shared(tmp_path_factory, "bridge/swim_flow", _swim_flow)


def _swim_flow():
    jcfg, tcfg = tp.configs(n=N, view_degree=16, gossip=GOSSIP)
    jsim = JSimulation(jcfg, seed=5)
    sides = make_sides(jsim, tcfg, TSimulation, tp.make_draws_fn(jcfg),
                       tp.to_tick_draws, convert.sim_state_from)
    off = np.asarray(jsim.topo.off)
    rec = {}
    # A live holder: the trackers' majority refuses the claimant.
    rec["conflict"] = [type(_raises(lambda s=s: s.br.attach(SEAT))).__name__
                       for s in sides]
    # SEAT's process restarts as an agent at once (an operator takeover at
    # incarnation 2) and joins by push-pull to SEAT + 1; HOLDER dies.
    for s in sides:
        s.sim.kill((np.arange(N) == SEAT) | (np.arange(N) == HOLDER))
        tr = s.br.attach(SEAT, replace=True)
        s.agents[SEAT] = ScriptedAgent(tr, s.sim.cfg, incarnation=2, seed=3)
        s.agents[SEAT].start_join(tbridge.seat_addr((SEAT + 1) % N))
        s.sim.run(1, chunk=1, with_metrics=False)
        s.br.step()
        s.agents[SEAT].finish_join()
    check(sides, "joined")
    lockstep(sides, JOIN_TICKS // 2, "join")
    for s in sides:  # garbage and an empty packet: dropped
        tr = s.br.transports[SEAT]
        tr.write_to(b"\xff\xfe garbage", tbridge.seat_addr(5))
        tr.write_to(b"", tbridge.seat_addr(5))
    lockstep(sides, JOIN_TICKS - JOIN_TICKS // 2, "garbage")
    agent = sides[1].agents[SEAT]
    dense = sides[1].swim()
    rec.update(members=len(agent.alive_members()), rtts=len(agent.rtt_log),
               joined=beliefs(dense, SEAT, off),
               mirror=dense.viv.vec[SEAT].numpy().copy(),
               agent_vec=agent.vec.copy(),
               holder=beliefs(dense, HOLDER, off))
    # The dead holder's seat: the majority holds it dead, so a claimant
    # takes it without replace.
    rec["takeover"] = [_raises(lambda s=s: s.br.attach(HOLDER))
                       for s in sides]
    for s in sides:  # the agent's process is gone
        s.br.transports[SEAT].shutdown()
        s.agents.pop(SEAT)
    lockstep(sides, DOWN_TICKS, "down")
    rec.update(alive_after=[bool(s.swim().alive_truth[SEAT]) for s in sides],
               down=beliefs(sides[1].swim(), SEAT, off),
               twice=[type(_raises(lambda s=s: s.br.attach(SEAT,
                                                           replace=True)))
                      .__name__ for s in sides])
    return rec


def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test inspects the type
        return e
    return None


def test_name_conflict_refused_by_the_majority(swim_flow):
    assert swim_flow["conflict"] == ["NameConflict"] * 3


def test_dead_holder_takeover(swim_flow):
    """The killed holder's trackers mostly hold it suspect or dead, and a
    claimant wins the seat without ``replace``."""
    assert majority(swim_flow["holder"], lambda inc, st: st != merge.ALIVE)
    assert swim_flow["takeover"] == [None] * 3


def test_join_learns_membership_and_is_believed_alive(swim_flow):
    """Push-pull taught the agent its neighborhood, and the seat's live
    trackers mostly hold it alive at its new incarnation."""
    assert swim_flow["members"] >= 16
    assert majority(swim_flow["joined"],
                    lambda inc, st: st == merge.ALIVE and inc >= 2)


def test_coordinate_mirrored_into_the_seat_row(swim_flow):
    assert swim_flow["rtts"] >= 10
    assert np.linalg.norm(swim_flow["agent_vec"]) > 0
    assert np.linalg.norm(swim_flow["mirror"]) > 0


def test_shutdown_detected_as_death(swim_flow):
    """The seat's ground truth goes down at the next step; within
    DOWN_TICKS most of its live trackers suspect it or hold it dead."""
    assert swim_flow["alive_after"] == [False] * 3
    assert majority(swim_flow["down"], lambda inc, st: st != merge.ALIVE)
    assert any(st == merge.DEAD for _, st in swim_flow["down"])


def test_attach_twice_refused(swim_flow):
    assert swim_flow["twice"] == ["ValueError"] * 3


# ----------------------------------------------------------------------
# The serf flow
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def serf_flow(tmp_path_factory):
    return tp.shared(tmp_path_factory, "bridge/serf_flow", _serf_flow)


def _serf_flow():
    jcfg, tcfg = tp.configs(n=SERF_N, view_degree=16, gossip=GOSSIP)
    jsim = JSerfSimulation(jcfg, seed=6)
    sides = make_sides(jsim, tcfg, TSerfSimulation, tp.make_serf_draws_fn(jcfg),
                       tp.to_serf_draws, convert.serf_state_from)
    for s in sides:
        s.step(SERF_FORM)
        tr = s.br.attach(SERF_SEAT, replace=True)
        s.agents[SERF_SEAT] = ScriptedAgent(tr, s.sim.cfg, seed=4)
        s.agents[SERF_SEAT].start_join(tbridge.seat_addr(SERF_SEAT + 1))
    lockstep(sides, 2, "joined")
    rec = {}
    delivered0 = sides[1].sim.state.ev_delivered.clone()
    origin0 = np.arange(SERF_N) == 0
    for s in sides:
        tr = s.br.transports[SERF_SEAT]
        for name, ltime in (("deploy", 1), ("rolling-restart", 2)):
            tr.write_to(codec.encode_packet([codec.encode_serf_message(
                codec.SERF_USER_EVENT, {"LTime": ltime, "Name": name,
                                        "Payload": b"v3", "CC": True})]),
                tbridge.seat_addr(SERF_SEAT + 1))
        tr.write_to(codec.encode_packet([bytes([MessageType.USER, 99])]),
                    tbridge.seat_addr(0))
        tr.write_to(codec.encode_packet([bytes([MessageType.USER])]),
                    tbridge.seat_addr(0))
        s.sim.user_event(origin0, 7)
        s.sim.query(origin0, 5)
    rec["qid"] = int(sides[1].sim.state.q_open_key[0, 0])
    lockstep(sides, 24, "events")
    for s in sides:  # an agent-fired query, retransmitted once
        msg = codec.encode_serf_message(codec.SERF_QUERY, {
            "LTime": 1, "ID": 7, "Addr": b"", "Port": 7946, "Filters": [],
            "Flags": 0, "RelayFactor": 0, "Timeout": 0, "Name": "who-has",
            "Payload": b"key7"})
        for _ in range(2):
            s.br.transports[SERF_SEAT].write_to(
                codec.encode_packet([msg]), tbridge.seat_addr(SERF_SEAT + 1))
    lockstep(sides, 24, "query")
    gained = (sides[1].sim.state.ev_delivered - delivered0).numpy()
    gained[SERF_SEAT] = 1
    agent = sides[1].agents[SERF_SEAT]
    rec.update(gained_min=int(gained.min()), events=list(agent.events_seen),
               answered=list(agent.queries_answered),
               status_sim=[s.br.query_status(0) for s in sides],
               status_seat=[s.br.query_status(SERF_SEAT) for s in sides],
               trackers=[sorted((k, v["origin_seat"])
                                for k, v in s.br.query_tracker.items())
                         for s in sides])
    # The name registry: the full id space, then LRU eviction.
    for s in sides:
        br = s.br
        for i in range(256):
            br._register_name(br._event_names, br._event_name_ids,
                              br._event_payloads, f"n{i}", b"")
        br._register_name(br._event_names, br._event_name_ids,
                          br._event_payloads, "n0", b"")
    lockstep(sides, 2, "registry")
    rec["collisions"] = [list(s.br.collisions) for s in sides]
    rec["ids"] = [dict(s.br._event_name_ids) for s in sides]
    return rec


def test_agent_events_reach_sim_nodes(serf_flow):
    assert serf_flow["gained_min"] >= 1


def test_sim_event_and_name_registry_reach_the_agent(serf_flow):
    ev = serf_flow["events"]
    assert ev.count("evt-7") == 1
    assert "rolling-restart" in ev and "deploy" in ev


def test_sim_query_answered_across_the_seam(serf_flow):
    assert serf_flow["qid"] in serf_flow["answered"]
    ref, dense, packed = serf_flow["status_sim"]
    assert dense == ref == packed
    assert dense["agent_acks"] == [tbridge.seat_name(SERF_SEAT)]
    assert dense["agent_responses"] == {
        tbridge.seat_name(SERF_SEAT): tbridge.seat_name(SERF_SEAT).encode()}
    assert dense["responses_total"] == SERF_N - 1


def test_agent_fired_query_disseminates(serf_flow):
    ref, dense, packed = serf_flow["status_seat"]
    assert dense == ref == packed
    assert dense["responses_total"] > SERF_N // 2
    t_ref, t_dense, t_packed = serf_flow["trackers"]
    assert t_dense == t_ref == t_packed
    assert any(o == SERF_SEAT for _, o in t_dense)


def test_name_registry_lru_eviction(serf_flow):
    ref, dense, packed = serf_flow["collisions"]
    assert dense == ref == packed
    assert dense and all(new.startswith("n") for _, new in dense)
    assert serf_flow["ids"][1] == serf_flow["ids"][0] == serf_flow["ids"][2]


def test_bridge_refuses_a_mesh():
    cfg = tp.configs(n=64, view_degree=16)[1]
    sim = TSimulation(cfg, seed=1, kernel="torch", device="cpu",
                      mesh=["cpu"] * 2)
    with pytest.raises(ValueError, match="one device"):
        tbridge.PacketBridge(sim)


# ----------------------------------------------------------------------
# The reference tests' outcomes, on the port's side at their sizes
# ----------------------------------------------------------------------

REF_BRIDGED = 400               # tests/test_bridge.py:195


def in_neighbour_beliefs(st, topo, seat):
    """(row, incarnation, status) of every live in-neighbour of ``seat``
    (tests/test_bridge.py:166-178), from a dense SWIM plane."""
    out = []
    n = st.alive_truth.shape[0]
    for j, o in enumerate(topo.off_host):
        r = (seat - o) % n
        if bool(st.alive_truth[r]):
            key = int(st.view_key[r, j])
            out.append((r, key >> 2, key & 3))
    return out


@pytest.fixture(scope="module")
def agent_outcomes(tmp_path_factory):
    return tp.shared(tmp_path_factory, "bridge/agent_outcomes", _agent_outcomes)


def _agent_outcomes():
    """tests/test_bridge.py's joined_world on the port (packed, plain
    tick, default timeouts): the cluster detects the seat's death; an agent at
    incarnation 2 rejoins there and runs 400 bridged ticks; then it shuts
    down and the cluster converges again."""
    cfg = TSimConfig(n=N, view_degree=16)
    sim = TSimulation(cfg, seed=5, layout="packed", kernel="torch",
                      device="cpu")
    sim.run(64, with_metrics=False)
    sim.kill(np.arange(N) == SEAT)
    ok, _, _ = sim.run_until_converged(max_ticks=1024, chunk=128)
    assert ok, "cluster failed to detect the seat's death"
    side = Side(sim, tbridge)
    tr = side.br.attach(SEAT)
    agent = ScriptedAgent(tr, cfg, incarnation=2, seed=3)
    side.agents[SEAT] = agent
    agent.start_join(tbridge.seat_addr((SEAT + 1) % N))
    sim.run(1, chunk=1, with_metrics=False)
    side.br.step()
    agent.finish_join()
    side.step(REF_BRIDGED)
    st = sim.swim_state
    h = tmetrics.health(cfg, sim.topo, st)
    rec = dict(joined=in_neighbour_beliefs(st, sim.topo, SEAT),
               false_positive=float(h.false_positive),
               undetected=float(h.undetected),
               mirror=st.viv.vec[SEAT].numpy().copy(),
               agent_vec=agent.vec.copy(), rtts=len(agent.rtt_log))
    errs = []
    for peer, _ in agent.rtt_log[-40:]:
        j = int(peer.split("-")[1])
        est = float(tvivaldi.distance(
            torch.tensor(agent.vec, dtype=torch.float32),
            torch.tensor(agent.height, dtype=torch.float32),
            torch.tensor(0.0), st.viv.vec[j], st.viv.height[j],
            st.viv.adjustment[j]))
        errs.append(est - float(ttopology.true_rtt(sim.world, SEAT, j)))
    rec["rmse"] = float(np.sqrt(np.mean(np.square(errs))))
    tr.shutdown()
    side.agents.clear()
    side.step(8)
    rec["alive_after"] = bool(sim.swim_state.alive_truth[SEAT])
    rec["reconverged"], _, _ = sim.run_until_converged(max_ticks=1024,
                                                       chunk=128)
    rec["down"] = in_neighbour_beliefs(sim.swim_state, sim.topo, SEAT)
    return rec


def test_agent_believed_alive_by_every_live_in_neighbour(agent_outcomes):
    """tests/test_bridge.py:212-218."""
    live = agent_outcomes["joined"]
    assert live, "no live in-neighbours"
    assert all(st == merge.ALIVE and inc >= 2 for _, inc, st in live), live


def test_cluster_health_with_the_external_seat(agent_outcomes):
    """tests/test_bridge.py:220-224."""
    assert agent_outcomes["false_positive"] == 0.0
    assert agent_outcomes["undetected"] == 0.0


def test_agent_vivaldi_converges(agent_outcomes):
    """tests/test_bridge.py:226-242."""
    assert agent_outcomes["rtts"] >= 30, "agent observed too few RTTs"
    assert agent_outcomes["rmse"] < 0.015, \
        f"agent coordinate RMSE {agent_outcomes['rmse'] * 1000:.1f} ms"


def test_agent_coordinate_mirrored_within_5ms(agent_outcomes):
    """tests/test_bridge.py:244-254."""
    mirror, mine = agent_outcomes["mirror"], agent_outcomes["agent_vec"]
    assert np.linalg.norm(mine) > 0, "agent never moved its coordinate"
    assert np.linalg.norm(mirror) > 0, "coordinate never mirrored"
    assert np.linalg.norm(mirror - mine) < 0.005


def test_shutdown_held_dead_by_every_live_in_neighbour(agent_outcomes):
    """tests/test_bridge.py:256-267."""
    assert agent_outcomes["alive_after"] is False
    assert agent_outcomes["reconverged"]
    assert agent_outcomes["down"]
    assert all(st in (merge.DEAD, merge.LEFT)
               for _, _, st in agent_outcomes["down"])


FLEET_N, FLEET_AGENTS = 256, 32                      # test_bridge_scale.py:20-21
FLEET_SEATS = list(range(64, 64 + FLEET_AGENTS))


class FleetAgent:
    """tests/test_bridge_scale.py's MiniAgent on the port's codec: acks
    its probes, acks and answers queries, remembers the events it saw."""

    def __init__(self, name, transport):
        self.name = name
        self.tr = transport
        self.events_seen = []
        self.queries_answered = []

    def pump(self):
        while not self.tr.packet_ch.empty():
            pkt = self.tr.packet_ch.get()
            try:
                msgs = codec.decode_packet(pkt.buf)
            except Exception:  # noqa: BLE001 — hostile bytes: drop
                continue
            for mtype, body in msgs:
                if mtype == MessageType.PING:
                    ack = codec.encode_message(
                        MessageType.ACK_RESP,
                        {"SeqNo": body["SeqNo"], "Payload": b""})
                    self.tr.write_to(codec.encode_packet([ack]),
                                     pkt.from_addr)
                elif mtype == MessageType.USER and "Raw" in body:
                    self._serf(*codec.decode_serf_message(body["Raw"]))

    def _serf(self, stype, sbody):
        if stype == codec.SERF_USER_EVENT:
            self.events_seen.append(str(sbody.get("Name")))
        elif stype == codec.SERF_QUERY:
            qid = int(sbody.get("ID", 0))
            if qid in self.queries_answered:
                return
            self.queries_answered.append(qid)
            origin = codec.as_bytes(sbody.get("Addr", b"")).decode()
            for flags, payload in ((1, b""), (0, self.name.encode())):
                resp = codec.encode_serf_message(
                    codec.SERF_QUERY_RESPONSE,
                    {"LTime": sbody.get("LTime", 0), "ID": qid,
                     "From": self.name, "Flags": flags, "Payload": payload})
                self.tr.write_to(codec.encode_packet([resp]), origin)


def _run_fleet(sim, br, agents, ticks):
    for _ in range(ticks):
        sim.run(1, chunk=1, with_metrics=False)
        br.step()
        for a in agents:
            a.pump()


@pytest.fixture(scope="module")
def fleet_outcomes(tmp_path_factory):
    return tp.shared(tmp_path_factory, "bridge/fleet_outcomes", _fleet_outcomes)


def _fleet_outcomes():
    """tests/test_bridge_scale.py's fleet and its three flows, in order, on
    the port (packed serf plane, plain tick)."""
    sim = TSerfSimulation(TSimConfig(n=FLEET_N, view_degree=16), seed=9,
                          layout="packed", kernel="torch", device="cpu")
    sim.run(8, chunk=8, with_metrics=False)
    br = tbridge.PacketBridge(sim)
    agents = [FleetAgent(f"agent-{s}", br.attach(s, replace=True))
              for s in FLEET_SEATS]
    rec = {}
    _run_fleet(sim, br, agents, 120)
    st = sim.serf_state.swim
    statuses = merge.key_status(st.view_key).numpy()
    alive = st.alive_truth.numpy()
    nbrs = ttopology.nbrs_table(sim.topo).numpy()
    rec["seats_alive"] = bool(alive[FLEET_SEATS].all())
    rec["seen_dead"] = sum(
        int(j in FLEET_SEATS and statuses[i, c] == merge.DEAD)
        for i in np.nonzero(alive)[0][:64] for c, j in enumerate(nbrs[i]))
    ev = codec.encode_serf_message(codec.SERF_USER_EVENT, {
        "LTime": 50, "Name": "fleet-deploy", "Payload": b"x", "CC": True})
    agents[0].tr.write_to(codec.encode_packet([ev]), tbridge.seat_addr(0))
    delivered0 = sim.state.ev_delivered.numpy().copy()
    _run_fleet(sim, br, agents, 60)
    active = sim.serf_state.swim.alive_truth.numpy().copy()
    active[FLEET_SEATS] = False  # external seats deliver agent-side
    rec["gained_min"] = int(
        (sim.state.ev_delivered.numpy() - delivered0)[active].min())
    rec["heard"] = sum("fleet-deploy" in a.events_seen
                       or any("fleet" in e for e in a.events_seen)
                       for a in agents[1:])
    sim.query(np.arange(FLEET_N) == 0, name=31)
    _run_fleet(sim, br, agents, 80)
    rec["query"] = br.query_status(0)
    return rec


def test_fleet_agents_stay_alive_under_probing(fleet_outcomes):
    """tests/test_bridge_scale.py:89-107."""
    assert fleet_outcomes["seats_alive"]
    assert fleet_outcomes["seen_dead"] == 0


def test_fleet_event_reaches_sim_and_other_agents(fleet_outcomes):
    """tests/test_bridge_scale.py:109-127."""
    assert fleet_outcomes["gained_min"] >= 1
    assert fleet_outcomes["heard"] >= (FLEET_AGENTS - 1) * 3 // 4, \
        fleet_outcomes["heard"]


def test_fleet_query_collects_answers(fleet_outcomes):
    """tests/test_bridge_scale.py:129-139."""
    st = fleet_outcomes["query"]
    assert st is not None
    assert st["responses_total"] >= FLEET_N - FLEET_AGENTS - 2
    assert len(st["agent_responses"]) >= FLEET_AGENTS * 3 // 4
