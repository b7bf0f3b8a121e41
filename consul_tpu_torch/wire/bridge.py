"""The tpu-sim transport seam: real agents on the simulated fabric.

This is the BASELINE-named integration boundary: the reference's
``memberlist.Transport`` is a six-method interface (reference
vendor/github.com/hashicorp/memberlist/transport.go:27-65) behind which
an in-process mock network already exists (mock_transport.go:12-121) —
the model for this module. A *real* (non-simulated) agent gets a
:class:`BridgeTransport` whose methods mirror that interface:

    final_advertise_addr(ip, port)   FinalAdvertiseAddr
    write_to(buf, addr) -> ts        WriteTo (best-effort packets)
    packet_ch                        PacketCh (queue of Packet)
    dial_timeout(addr, timeout)      DialTimeout (reliable streams)
    stream_ch                        StreamCh (queue of Stream)
    shutdown()                       Shutdown

and whose wire format is memberlist's own: msgType-framed msgpack
bodies, compound batching, optional stream encryption — all via
wire/codec.py. The agent literally joins the simulated cluster: its
packets merge into sim views, sim nodes probe it, its liveness is
decided by whether it answers, and its Vivaldi coordinate converges
against the sim's planted latency model.

Seat semantics. Each attached agent claims a **seat** (a node index)
in the simulated world; ``SimState.external[seat]`` is set so the
simulation answers probes *to* the seat from ground truth but never
originates protocol traffic *for* it (models/state.py) — the real
agent does that itself through this bridge. Concretely, per
:meth:`PacketBridge.step` (host-side, once per tick — the batched
host<->device boundary of SURVEY §7, precedent: the reference's 5 s
coordinate batching, agent/consul/coordinate_endpoint.go:42-53):

  - inbound agent packets are decoded and staged: membership facts
    join into the receiving seat's device view row (and the agent's
    own-alive announcements bump ``own_inc[seat]``), so the sim
    epidemic spreads them;
  - the agent's announced coordinate is written into the seat's device
    Vivaldi row, so sim probes of the seat feed on its real coordinate;
  - sim-side probes of the agent are emitted as real ping packets from
    neighbor addresses; unanswered probes eventually flip the seat's
    ground truth to dead, so the sim detects a crashed agent
    organically (no special-casing);
  - neighbor gossip is emitted to the agent as compound
    alive/suspect/dead messages, and push-pull streams answer with the
    seat's neighborhood state (pushPullHeader/pushNodeState schema,
    net.go:145-168).

Time and RTT. The bridge runs on **simulated time** (tick *
tick_ms/1000 seconds). ``write_to`` returns the send timestamp and
reply packets carry ``timestamp = send + model_rtt`` — exactly the
Transport contract's RTT mechanism (transport.go:36-43: the timestamps
exist "to help make accurate RTT measurements during probes"), with
the RTT drawn from the same planted-world latency model the simulation
itself uses, so the agent's Vivaldi solves the same geometry.
"""

from __future__ import annotations

import dataclasses
import queue
import time
from typing import Optional

import numpy as np
import torch

from consul_tpu_torch.models import layout as layout_mod
from consul_tpu_torch.models import serf as serf_mod
from consul_tpu_torch.ops import merge, scaling, topology
from consul_tpu_torch.wire import _msgpack, codec
from consul_tpu_torch.wire.codec import MessageType
from consul_tpu_torch.wire.keyring import Keyring

# memberlist nodeStateType values (state.go:754-760); distinct from the
# sim's merge-lattice codes, translated at the seam.
WIRE_ALIVE = 0
WIRE_SUSPECT = 1
WIRE_DEAD = 2
WIRE_LEFT = 3

_TO_WIRE = {merge.ALIVE: WIRE_ALIVE, merge.SUSPECT: WIRE_SUSPECT,
            merge.DEAD: WIRE_DEAD, merge.LEFT: WIRE_LEFT}
_FROM_WIRE = {v: k for k, v in _TO_WIRE.items()}

# Protocol version vector (pushNodeState.Vsn, net.go:166: [pmin, pmax,
# pcur, dmin, dmax, dcur]).
VSN = [1, 5, 1, 2, 5, 4]


def _node_state(seat: int, incarnation: int, state: int) -> dict:
    """One pushNodeState body (net.go:158-168)."""
    return {
        "Name": seat_name(seat), "Addr": seat_name(seat).encode(),
        "Port": 7946, "Meta": b"", "Incarnation": incarnation,
        "State": state, "Vsn": bytes(VSN),
    }


def seat_name(i: int) -> str:
    return f"sim-{i}"


def seat_addr(i: int) -> str:
    return f"{seat_name(i)}:7946"


def addr_to_seat(addr: str) -> int:
    host = addr.split(":", 1)[0]
    if not host.startswith("sim-"):
        raise ValueError(f"not a sim address: {addr!r}")
    return int(host[4:])


def encode_coordinate(vec, height, error, adjustment) -> bytes:
    """Ping-ack coordinate payload (serf/ping_delegate.go:28-45 encodes
    the serf coordinate.Coordinate struct as the ack payload)."""
    return codec._pack_go({
        "Vec": [float(x) for x in vec], "Error": float(error),
        "Adjustment": float(adjustment), "Height": float(height),
    })


def decode_coordinate(payload: bytes) -> Optional[dict]:
    if not payload:
        return None
    if isinstance(payload, str):
        # decode_message maps legacy-raw to str via surrogateescape;
        # recover the original payload bytes the same way.
        payload = payload.encode("utf-8", "surrogateescape")
    return _msgpack.unpackb(payload)


class NameConflict(ValueError):
    """A live member already holds this name and the cluster majority
    agrees (reference serf.go:1413-1486 name-conflict resolution)."""


@dataclasses.dataclass
class Packet:
    """transport.go:10-22."""
    buf: bytes
    from_addr: str
    timestamp: float  # simulated seconds


class Stream:
    """In-memory reliable bidirectional message stream — the net.Pipe of
    mock_transport.go:117-120. ``send``/``recv`` move whole frames (the
    codec's stream framing handles encryption)."""

    def __init__(self):
        self._a: queue.Queue = queue.Queue()
        self._b: queue.Queue = queue.Queue()
        self.closed = False

    def peer(self) -> "Stream":
        p = Stream.__new__(Stream)
        p._a, p._b = self._b, self._a
        p.closed = False
        return p

    def send(self, frame: bytes):
        self._a.put(frame)

    def recv(self, timeout: float = 1.0) -> bytes:
        return self._b.get(timeout=timeout)

    def close(self):
        self.closed = True


class BridgeTransport:
    """The agent-facing six-method Transport (transport.go:27-65)."""

    def __init__(self, bridge: "PacketBridge", seat: int):
        self._bridge = bridge
        self.seat = seat
        self.addr = seat_addr(seat)
        self.packet_ch: queue.Queue = queue.Queue()
        self.stream_ch: queue.Queue = queue.Queue()
        self.down = False

    def final_advertise_addr(self, ip: str = "", port: int = 0):
        """FinalAdvertiseAddr: the seat's simulated address wins over
        any user-configured value (net_transport.go would consult the
        bound socket here)."""
        return seat_name(self.seat), 7946

    def write_to(self, buf: bytes, addr: str) -> float:
        """Best-effort packet send; returns the transmit timestamp (in
        simulated seconds) for RTT measurement."""
        if self.down:
            raise RuntimeError("transport is shut down")
        now = self._bridge.now()
        self._bridge._inbound(self.seat, buf, addr, now)
        return now

    def dial_timeout(self, addr: str, timeout: float = 1.0) -> Stream:
        if self.down:
            raise RuntimeError("transport is shut down")
        return self._bridge._dial(self.seat, addr)

    def shutdown(self):
        """The agent's process is gone: its seat stops answering and
        the simulated cluster is left to detect the failure (the
        reference cluster likewise only learns via SWIM)."""
        self.down = True
        self._bridge._agent_down(self.seat)


class PacketBridge:
    """Wires external agents into a running :class:`Simulation`.

    One instance per simulated DC; drive it with ``bridge.step()``
    after every ``sim`` tick (or use :meth:`run`)."""

    def __init__(self, sim, keyring: Optional[Keyring] = None,
                 probe_miss_limit: int = 2):
        if getattr(sim, "mesh", None) is not None:
            raise ValueError(
                "the packet bridge runs on one device: set_mesh(None) "
                "before attaching agents")
        self.sim = sim
        self.keyring = keyring
        self.probe_miss_limit = probe_miss_limit
        self.transports: dict[int, BridgeTransport] = {}
        # Per-seat probe bookkeeping (host-side ints, sim-time ticks).
        self._next_probe: dict[int, int] = {}
        self._pending: dict[int, tuple[int, int]] = {}  # seat -> (seq, deadline)
        self._misses: dict[int, int] = {}
        self._seq = 0
        # Staged device writes, applied once per step.
        self._stage_view: list[tuple[int, int, int]] = []  # (row, col, key)
        self._stage_inc: dict[int, int] = {}
        self._stage_coord: dict[int, dict] = {}
        self._stage_alive: dict[int, bool] = {}
        # Streams dialed but not yet answered: (from, to, stream,
        # deadline_tick).
        self._pending_streams: list = []
        # Host-side copy of the offset table (no per-fact transfers).
        topo = sim.topo
        self._off = np.asarray(topo.off_host if topo.off_host
                               else topo.off.cpu().numpy(), np.int64)
        # Host copies of gathered SWIM rows, valid while ``sim.state`` is
        # the object they were read from (see :meth:`_fetch`).
        self._rows: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._rows_of = None
        # Noise-free RTTs of the planted world by (a, b): the world never
        # changes, so each pair is read from the device once.
        self._rtt: dict[tuple[int, int], float] = {}
        # Cumulative host-side costs: bytes copied device-to-host, and the
        # host-clock seconds spent gathering rows and writing them back.
        self.stats = {"d2h_bytes": 0, "fetch_s": 0.0, "write_s": 0.0}
        # Serf user events (needs a serf-level driver, cluster.
        # SerfSimulation): fired-event staging, the string<->int name
        # registry (the sim's event plane keys names as 8-bit ints —
        # models/serf.py make_event_key; a documented narrowing), and
        # per-agent delivered-event dedup for the outbound feed.
        self._serf = bool(getattr(sim, "_serf_plane", False))
        self._stage_fired: list[tuple[int, int]] = []   # (seat, name_int)
        # Serf queries across the seam (serf/query.go): agent-fired
        # queries stage into the device plane; agent responses to
        # sim-origin queries tally into q_acks/q_resps; and the tracker
        # keeps the per-responder names + payload bytes the device
        # plane's counts cannot carry (the reference's QueryResponse
        # acks/responses channels, host-side).
        self._stage_query: list[tuple[int, int]] = []   # (seat, name_int)
        self._stage_qtally: list[tuple[int, bool]] = []  # (origin, is_resp)
        self._known_queries: dict[tuple, None] = {}     # (name, ltime)
        self._query_names: dict[int, str] = {}
        self._query_name_ids: dict[str, int] = {}   # reverse map (O(1))
        self._query_payloads: dict[int, bytes] = {}
        # (ltime, name_int) -> {"acks": [member], "responses":
        #   {member: payload}, "origin_seat": int|None}
        self.query_tracker: dict[tuple[int, int], dict] = {}
        self._event_names: dict[int, str] = {}
        self._event_name_ids: dict[str, int] = {}   # reverse map (O(1))
        # (evicted-name, newly-registered-name) pairs, recorded when a
        # new name takes over a least-recently-used id under full
        # occupancy — the NEW name holds the id from then on.
        self.collisions: list[tuple[str, str]] = []
        # The sim plane stores only packed keys; payloads ride this
        # host-side registry (latest per name slot) across the seam.
        self._event_payloads: dict[int, bytes] = {}
        # (name_int, ltime) pairs already fired or echoed (bounded).
        self._known_events: dict[tuple, None] = {}
        # Bounded per-agent delivered-key dedup (insertion-ordered; the
        # sim's own retention is ltime-bucketed, so old keys can never
        # redeliver once evicted here either).
        self._delivered_events: dict[int, dict] = {}
        # Host-side queue bound: the reference's dynamic depth limit
        # max(2N, MinQueueDepth) (getQueueMax, serf/serf.go:1612-1624)
        # guards these unbounded-in-Go structures; 2x for _known_events
        # which holds two insert sites' worth.
        scfg = sim.cfg.serf
        # A computed limit of 0 (min_queue_depth=0 with the unlimited
        # max_queue_depth=0 default) must mean "unbounded" here — an
        # empty dedup dict would re-deliver every event each tick and
        # feed the agent-echo loop this buffer exists to break — so 0
        # falls back to the Consul MinQueueDepth floor. A deliberately
        # small nonzero configured cap is respected.
        self._queue_max = scaling.queue_max_depth(
            scfg.max_queue_depth, scfg.min_queue_depth, sim.cfg.n
        ) or 4096

    # ------------------------------------------------------------------
    # Device rows: gathered reads, row-local writes
    # ------------------------------------------------------------------
    def _check_placement(self):
        if getattr(self.sim, "mesh", None) is not None:
            raise ValueError("the packet bridge runs on one device; the "
                             "simulation was put on a mesh")

    def _swim_at_rest(self):
        st = self.sim.state
        return st.swim if self._serf else st

    def _fetch(self, rows) -> dict:
        """Host copies of SWIM rows of the current state: ``row ->
        (ints, floats)``, ints ``[alive, left, external, own_inc,
        view_key[K], tx_left[K]]`` (int64), floats ``[vec[D], height,
        error, adjustment]`` (float32). Rows not yet copied are gathered
        from the state at rest, unpacked and copied in one transfer."""
        if self._rows_of is not self.sim.state:
            self._check_placement()
            self._rows, self._rows_of = {}, self.sim.state
        missing = sorted({int(r) for r in rows} - self._rows.keys())
        if missing:
            t0 = time.perf_counter()
            at_rest = self._swim_at_rest()
            idx = torch.tensor(missing, dtype=torch.int64,
                               device=at_rest.t.device)
            st = _unpacked(layout_mod.take_rows(at_rest, idx))
            i64 = torch.int64
            ints = torch.cat([
                st.alive_truth.to(i64)[:, None], st.left.to(i64)[:, None],
                st.external.to(i64)[:, None], st.own_inc[:, None],
                st.view_key, st.tx_left], dim=1).cpu().numpy()
            v = st.viv
            flts = torch.cat([v.vec, v.height[:, None], v.error[:, None],
                              v.adjustment[:, None]], dim=1).cpu().numpy()
            for i, r in enumerate(missing):
                self._rows[r] = (ints[i], flts[i])
            self.stats["d2h_bytes"] += ints.nbytes + flts.nbytes
            self.stats["fetch_s"] += time.perf_counter() - t0
        return self._rows

    def _row(self, r: int):
        return self._fetch([r])[int(r)]

    def _alive(self, r: int) -> bool:
        return bool(self._row(r)[0][0])

    def _left(self, r: int) -> bool:
        return bool(self._row(r)[0][1])

    def _external(self, r: int) -> bool:
        return bool(self._row(r)[0][2])

    def _own_inc(self, r: int) -> int:
        return int(self._row(r)[0][3])

    def _view_row(self, r: int) -> np.ndarray:
        k = self._off.shape[0]
        return self._row(r)[0][4:4 + k]

    def _tx_row(self, r: int) -> np.ndarray:
        k = self._off.shape[0]
        return self._row(r)[0][4 + k:4 + 2 * k]

    def _edit_rows(self, rows, fn):
        """Apply ``fn(dense_rows, local) -> dense_rows`` to the SWIM rows
        ``rows`` (``local`` maps a row id to its index in the gathered
        block) and write them back: the state at rest is replaced by one
        whose gathered rows are the edited ones, packed as the state is.
        ``fn`` may change only the leaves of ``_EDITED``."""
        t0 = time.perf_counter()
        self._check_placement()
        rows = sorted({int(r) for r in rows})
        local = {r: i for i, r in enumerate(rows)}
        at_rest = self._swim_at_rest()
        idx = torch.tensor(rows, dtype=torch.int64, device=at_rest.t.device)
        sub = fn(_unpacked(layout_mod.take_rows(at_rest, idx)), local)
        if layout_mod.is_packed(at_rest):
            sub = layout_mod.pack(sub)
        whole = _put_rows(at_rest, idx, sub)
        st = self.sim.state
        self.sim.state = st._replace(swim=whole) if self._serf else whole
        self.stats["write_s"] += time.perf_counter() - t0

    # ------------------------------------------------------------------
    # Attachment
    # ------------------------------------------------------------------
    def attach(self, seat: int, replace: bool = False) -> BridgeTransport:
        """Claim ``seat`` for an external agent. The seat's ground truth
        becomes alive (the process exists) and ``external`` is set so
        the sim stops originating protocol traffic for it.

        Claiming a seat whose name is *currently held by a live in-sim
        member* is a name conflict; it resolves the reference's way
        (serf.go:1413-1486 handleNodeConflict -> resolveNodeConflict:
        query the cluster, majority keeps the name, the minority
        claimant shuts down): the seat's trackers vote with their
        current beliefs, and a majority-alive verdict rejects the
        newcomer with :class:`NameConflict`. A majority believing the
        seat dead/left means the cluster has moved on — the newcomer
        wins the name (the restarted-agent takeover case).
        ``replace=True`` skips the vote: an explicit operator takeover
        of a simulated member's seat. Only the trackers' rows are
        gathered for the vote (seat at column j of row seat - off[j])."""
        if seat in self.transports:
            raise ValueError(f"seat {seat} already attached")
        if not replace and self._alive(seat) and not self._external(seat) \
                and not self._left(seat):
            votes_alive = 0
            n = self.sim.cfg.n
            trackers = [(seat - int(self._off[j])) % n
                        for j in range(self._off.shape[0])]
            self._fetch(trackers)
            voters = 0
            for j, r in enumerate(trackers):
                if not (self._alive(r) and not self._left(r)):
                    continue
                # seat sits at column j of r's view: r + off[j] == seat.
                voters += 1
                if merge.key_status_int(int(self._view_row(r)[j])) \
                        == merge.ALIVE:
                    votes_alive += 1
            if voters and votes_alive * 2 > voters:
                raise NameConflict(
                    f"seat {seat} is held by a live member "
                    f"({votes_alive}/{voters} trackers vote alive)"
                )

        def claim(st, local):
            m = torch.zeros_like(st.external)
            m[local[seat]] = True
            return st._replace(external=st.external | m,
                               alive_truth=st.alive_truth | m,
                               left=st.left & ~m)
        self._edit_rows([seat], claim)
        t = BridgeTransport(self, seat)
        self.transports[seat] = t
        self._next_probe[seat] = int(self.sim._t) + 1
        self._misses[seat] = 0
        return t

    def now(self) -> float:
        g = self.sim.cfg.gossip
        return float(int(self.sim._t)) * g.tick_ms / 1000.0

    def _model_rtt(self, a: int, b: int) -> float:
        key = (int(a), int(b))
        rtt = self._rtt.get(key)
        if rtt is None:
            if len(self._rtt) >= 1 << 16:
                self._rtt.clear()
            rtt = self._rtt[key] = float(
                topology.true_rtt(self.sim.world, key[0], key[1]))
        return rtt

    def _seat_of(self, addr_or_name: str) -> int:
        """Parse and range-check a sim address; raises ValueError for
        seats outside the world (a real probe of a nonexistent address
        times out — it must never alias onto a live node via gather
        clamping or modulo wrap)."""
        seat = addr_to_seat(addr_or_name)
        if not 0 <= seat < self.sim.cfg.n:
            raise ValueError(f"seat {seat} outside world of {self.sim.cfg.n}")
        return seat

    # ------------------------------------------------------------------
    # Inbound: agent -> sim
    # ------------------------------------------------------------------
    def _inbound(self, from_seat: int, buf: bytes, addr: str, sent: float):
        try:
            to_seat = self._seat_of(addr)
        except ValueError:
            return  # not a sim address / out of range: dropped
        rtt = self._model_rtt(from_seat, to_seat)
        if to_seat in self.transports:
            # Agent-to-agent traffic: a real transport delivers the raw
            # packet to the peer's PacketCh (mock_transport.go WriteTo);
            # the bridge must not answer on a live agent's behalf.
            self._deliver(to_seat, buf, seat_addr(from_seat), sent + rtt)
            return
        try:
            msgs = codec.decode_packet(buf, keyring=self.keyring)
        except ValueError:
            return  # undecodable packet: best-effort transport drops it
        for mtype, body in msgs:
            try:
                self._handle_msg(from_seat, to_seat, mtype, body, sent, rtt)
            except (ValueError, KeyError, TypeError):
                # Malformed-but-decodable message (bad field, non-sim
                # target, missing SeqNo): best-effort packets drop, they
                # never propagate into the agent's send path.
                continue

    def _bounded_insert(self, d: dict, key, value=None, mult: int = 2):
        """Insert with the host-side queue bound (getQueueMax
        discipline, serf/serf.go:1612-1624): oldest entries evict."""
        d[key] = value
        while len(d) > mult * self._queue_max:
            d.pop(next(iter(d)))

    def _register_name(self, registry: dict, rev: dict, payloads: dict,
                       name: str, payload: bytes) -> tuple[int, bool]:
        """8-bit name-space registration shared by the event and query
        planes (the sim keys names as ints — a documented narrowing).
        Ids are DYNAMICALLY allocated: a known name keeps its id (an
        O(1) reverse-map hit, LRU-touched so recency tracks USE, and
        its payload refreshes — latest fire wins, as before); a new
        name takes the lowest free id; with all 256 ids held, the
        least-recently-USED name is evicted (recorded in
        ``self.collisions``). This uses the full id space — the
        previous crc32 hashing collided at the ~20-name birthday
        bound. Host-side dedup (`_known_events`/`_known_queries`) keys
        on the true NAME, not the id, so an evicted name's lingering
        retransmissions re-register under a fresh id without re-firing
        already-seen Lamport times. Residual narrowing: the device
        plane still sees at most 256 distinct names concurrently."""
        name_int = rev.get(name)
        if name_int is not None:
            payloads[name_int] = payload
            del registry[name_int]       # LRU touch: re-insert at tail
            registry[name_int] = name
            return name_int, False
        evicted_now = False
        if len(registry) < 256:
            name_int = next(i for i in range(256) if i not in registry)
        else:
            name_int, evicted = next(iter(registry.items()))
            del registry[name_int]
            del rev[evicted]
            self.collisions.append((evicted, name))
            evicted_now = True
        registry[name_int] = name
        rev[name] = name_int
        payloads[name_int] = payload
        return name_int, evicted_now

    def _track_query(self, lt: int, name_int: int) -> dict:
        rec = self.query_tracker.get((lt, name_int))
        if rec is None:
            rec = {"acks": [], "responses": {}, "origin_seat": None}
            self._bounded_insert(self.query_tracker, (lt, name_int), rec)
        return rec


    def _handle_msg(self, from_seat, to_seat, mtype, body, sent, rtt):
        if mtype == MessageType.PING:
            # Answer on behalf of the sim node, ack payload = its
            # coordinate (ping_delegate.go:28-45); the ack's timestamp
            # carries the model RTT (see module docstring).
            if not self._alive(to_seat) or self._left(to_seat):
                return
            f = self._row(to_seat)[1]
            d = f.shape[0] - 3
            payload = encode_coordinate(f[:d], float(f[d]), float(f[d + 1]),
                                        float(f[d + 2]))
            ack = codec.encode_message(
                MessageType.ACK_RESP,
                {"SeqNo": body["SeqNo"], "Payload": payload},
            )
            self._deliver(from_seat, codec.encode_packet([ack]),
                          seat_addr(to_seat), sent + rtt)
        elif mtype == MessageType.ACK_RESP:
            # The agent answered a sim-side probe: alive, and its
            # payload refreshes the seat's device coordinate.
            pend = self._pending.get(from_seat)
            if pend is not None and body["SeqNo"] == pend[0]:
                del self._pending[from_seat]
                self._misses[from_seat] = 0
            coord = decode_coordinate(body.get("Payload", b""))
            if coord is not None:
                self._stage_coord[from_seat] = coord
        elif mtype in (MessageType.ALIVE, MessageType.SUSPECT,
                       MessageType.DEAD):
            status = {MessageType.ALIVE: merge.ALIVE,
                      MessageType.SUSPECT: merge.SUSPECT,
                      MessageType.DEAD: merge.DEAD}[mtype]
            self._merge_fact(to_seat, body["Node"],
                             body["Incarnation"], status)
            # Mirror the fact into the sender's own seat row too: the
            # agent would not gossip what it does not believe, and the
            # seat's device view row is what sim-initiated push-pulls
            # read as "the agent's state".
            self._merge_fact(from_seat, body["Node"],
                             body["Incarnation"], status)
        elif mtype == MessageType.USER:
            # Serf envelope (serf rides memberlist user messages).
            stype, sbody = codec.decode_serf_message(body.get("Raw", b""))
            if stype == codec.SERF_USER_EVENT and self._serf:
                # Dedup across retransmissions AND the bridge's own
                # outbound echoes: a serf agent retransmits each event
                # several times and re-gossips what it receives; only
                # the first (name, ltime) sighting fires into the sim,
                # or one event would re-fire at fresh Lamport times
                # forever (an unbounded feedback loop).
                ev_name = str(sbody.get("Name", ""))
                name_int, _ = self._register_name(
                    self._event_names, self._event_name_ids,
                    self._event_payloads, ev_name,
                    codec.as_bytes(sbody.get("Payload", b"") or b""))
                # Dedup keys on the true NAME (not the 8-bit id): an
                # id reassigned after eviction must never alias another
                # name's Lamport times.
                ek = (ev_name, int(sbody.get("LTime", 0)))
                if ek in self._known_events:
                    return
                self._bounded_insert(self._known_events, ek)
                self._stage_fired.append((from_seat, name_int))
            elif stype == codec.SERF_QUERY and self._serf:
                # An attached agent fires a query (messageQueryType,
                # serf/messages.go): stage it into the device plane so
                # the epidemic carries it; dedup retransmissions like
                # user events.
                q_name = str(sbody.get("Name", ""))
                name_int, _ = self._register_name(
                    self._query_names, self._query_name_ids,
                    self._query_payloads, q_name,
                    codec.as_bytes(sbody.get("Payload", b"") or b""))
                qk = (q_name, int(sbody.get("LTime", 0)))
                if qk in self._known_queries:
                    return
                self._bounded_insert(self._known_queries, qk)
                self._stage_query.append((from_seat, name_int))
            elif stype == codec.SERF_QUERY_RESPONSE and self._serf:
                # An agent answers a sim-origin query addressed to the
                # origin's seat (messageQueryResponseType; Flags bit 0
                # marks a delivery ack, serf/query.go queryFlagAck).
                # Tally into the device counters and keep the
                # per-responder name + payload host-side.
                qid = int(sbody.get("ID", 0))
                slot = serf_mod.query_slot(self.sim.state, to_seat, qid)
                if slot < 0:
                    return  # closed or stale: drop, like the reference
                lt, name_int = qid >> 9, (qid >> 1) & 0xFF
                frm = str(sbody.get("From", "")) or seat_name(from_seat)
                rec = self._track_query(lt, name_int)
                rec["origin_seat"] = to_seat
                rec["slot"] = slot
                if int(sbody.get("Flags", 0)) & 1:
                    if frm not in rec["acks"]:
                        rec["acks"].append(frm)
                        self._stage_qtally.append((to_seat, slot, False))
                elif frm not in rec["responses"]:
                    rec["responses"][frm] = codec.as_bytes(
                        sbody.get("Payload", b"") or b"")
                    self._stage_qtally.append((to_seat, slot, True))
        elif mtype == MessageType.INDIRECT_PING:
            # Relay: target reachability from ground truth; ack or nack
            # back to the requester (net.go handleIndirectPing:491).
            raw_t = body["Target"]
            target = self._seat_of(
                codec.as_bytes(raw_t).decode("utf-8", "surrogateescape")
                if not isinstance(raw_t, str) else raw_t)
            up = self._alive(target) and not self._left(target)
            rtt2 = self._model_rtt(to_seat, target)
            if up:
                ack = codec.encode_message(
                    MessageType.ACK_RESP, {"SeqNo": body["SeqNo"],
                                           "Payload": b""})
                self._deliver(from_seat, codec.encode_packet([ack]),
                              seat_addr(to_seat), sent + rtt + rtt2)
            elif body.get("Nack"):
                nack = codec.encode_message(
                    MessageType.NACK_RESP, {"SeqNo": body["SeqNo"]})
                self._deliver(from_seat, codec.encode_packet([nack]),
                              seat_addr(to_seat), sent + rtt + rtt2)

    def _subject_col(self, row: int, subject: int) -> int:
        """Host-side column lookup (no device chatter per fact)."""
        topo = self.sim.topo
        d = (subject - row) % self.sim.cfg.n
        if d == 0:
            return topology.SELF
        if topo.dense:
            return d - 1
        off = self._off
        c = int(np.searchsorted(off, d))
        if c < off.shape[0] and off[c] == d:
            return c
        return topology.ABSENT

    def _merge_fact(self, to_seat: int, node: str, inc: int, status: int):
        """Stage a membership fact into the receiving seat's view row
        (the receiver-side delivery of a gossiped message)."""
        try:
            subject = self._seat_of(node)
        except ValueError:
            return  # fact about a node outside the simulated world
        if subject in self.transports and status == merge.ALIVE and \
                node == seat_name(subject):
            # An agent's own-alive announcement refreshes its seat's
            # incarnation (aliveNode on self, state.go:868-…).
            self._stage_inc[subject] = max(
                self._stage_inc.get(subject, 0), int(inc))
        col = self._subject_col(to_seat, subject)
        if col < 0:
            return  # receiver does not track the subject (partial view)
        self._stage_view.append(
            (to_seat, col, merge.make_key_int(inc, status)))

    # ------------------------------------------------------------------
    # Streams: push-pull (net.go:777-1070)
    # ------------------------------------------------------------------
    def _dial(self, from_seat: int, addr: str) -> Stream:
        to_seat = self._seat_of(addr)
        s = Stream()
        peer = s.peer()
        if to_seat in self.transports:
            # Dialing another attached agent: the stream goes to that
            # agent's StreamCh — the bridge never answers on a live
            # agent's behalf (same invariant as the packet path).
            self.transports[to_seat].stream_ch.put(peer)
            return s
        # The sim side of the stream is serviced at step() once the
        # caller's frame arrives (streams are "more expensive ...
        # infrequent", transport.go:50-54); unanswered dials expire
        # after a generous window.
        deadline = int(self.sim._t) + 50
        self._pending_streams.append((from_seat, to_seat, peer, deadline))
        return s

    def _neighborhood(self, seat: int) -> list:
        """The seats ``seat`` tracks: ``(seat + off[c]) % n``."""
        n = self.sim.cfg.n
        return [(seat + int(self._off[c])) % n
                for c in range(self._off.shape[0])]

    def _serve_stream(self, from_seat: int, to_seat: int, stream: Stream):
        """Answer one push-pull exchange on the sim side: read the
        agent's state, stage its merge, reply with the seat's
        neighborhood state (sendLocalState/mergeRemoteState).
        Returns True when the exchange completed (or was malformed),
        False when the caller's frame has not arrived yet."""
        try:
            frame = stream.recv(timeout=0)
        except queue.Empty:
            return False
        try:
            buf = codec.decode_stream_frame(frame, self.keyring)
            _, remote, _ = codec.decode_push_pull(buf)
        except ValueError:
            return True  # malformed: consumed, no reply
        for nstate in remote:
            self._merge_fact(
                to_seat, nstate["Name"], nstate["Incarnation"],
                _FROM_WIRE.get(nstate["State"], merge.SUSPECT),
            )
        # Reply: the dialed seat's own fact, plus the *caller's*
        # neighborhood. The reference replies with its full member map
        # (net.go:824-860); the sparse plane's equivalent of "the part
        # of the map the newcomer needs" is the caller's own view row —
        # the seats it will track, which by offset symmetry are exactly
        # the seats that track *it*, i.e. the audience its join
        # announcement must reach. Statuses come from the seat
        # directory (ground truth + incarnation), the converged
        # cluster's answer.
        states = [self._push_node_state(to_seat)]
        hood = self._neighborhood(from_seat)
        self._fetch(hood)
        for j in hood:
            up = self._alive(j) and not self._left(j)
            states.append(_node_state(
                j, self._own_inc(j), WIRE_ALIVE if up else WIRE_DEAD))
        reply = codec.encode_push_pull(states)
        stream.send(codec.encode_stream_frame(reply, self.keyring))
        return True

    def _push_node_state(self, seat: int) -> dict:
        if self._left(seat):
            wire = WIRE_LEFT
        elif self._alive(seat):
            wire = WIRE_ALIVE
        else:
            wire = WIRE_DEAD
        return _node_state(seat, self._own_inc(seat), wire)

    # ------------------------------------------------------------------
    # Outbound: sim -> agent
    # ------------------------------------------------------------------
    def _deliver(self, seat: int, buf: bytes, from_addr: str, ts: float):
        t = self.transports.get(seat)
        if t is not None and not t.down:
            t.packet_ch.put(Packet(buf, from_addr, ts))

    def _agent_down(self, seat: int):
        self._stage_alive[seat] = False

    def _in_neighbors(self, seat: int) -> list:
        """The seats that track ``seat``: ``(seat - off[c]) % n``."""
        n = self.sim.cfg.n
        return [(seat - int(self._off[c])) % n
                for c in range(self._off.shape[0])]

    def _prefetch(self, t_now: int):
        """Gather, in one transfer, every row this step reads: the
        pending streams' dialed seats and their callers' neighborhoods,
        the in-neighbors of every seat due a probe, and the event
        sources of the serf feed."""
        rows = set()
        for from_seat, to_seat, _, _ in self._pending_streams:
            rows.add(to_seat)
            rows.update(self._neighborhood(from_seat))
        k_deg = self._off.shape[0]
        for seat, tr in self.transports.items():
            if tr.down:
                continue
            pend = self._pending.get(seat)
            if t_now >= self._next_probe[seat] and (
                    pend is None or t_now >= pend[1]):
                rows.update(self._in_neighbors(seat))
            if self._serf:
                rows.add((seat - int(self._off[t_now % k_deg]))
                         % self.sim.cfg.n)
        if rows:
            self._fetch(rows)

    def _emit_probes_and_gossip(self):
        """Sim-side traffic toward each attached agent: probes on the
        seat's probe cadence from a rotating in-neighbor, with the
        neighbor's hottest facts piggybacked (gossip rides probe
        packets, net.go:631 piggyback)."""
        g = self.sim.cfg.gossip
        t_now = int(self.sim._t)
        topo = self.sim.topo
        n = self.sim.cfg.n
        off = self._off
        for seat, tr in list(self.transports.items()):
            if tr.down:
                continue
            # Missed-probe bookkeeping -> seat ground-truth death.
            pend = self._pending.get(seat)
            if pend is not None and t_now >= pend[1]:
                del self._pending[seat]
                self._misses[seat] = self._misses.get(seat, 0) + 1
                if self._misses[seat] >= self.probe_miss_limit:
                    self._stage_alive[seat] = False
            if t_now < self._next_probe[seat] or pend is not None:
                continue
            self._next_probe[seat] = t_now + g.probe_period_ticks
            # Rotate through in-neighbors as probe sources. An EXTERNAL
            # in-neighbor never sources a synthesized probe: its real
            # agent owns its own probing, and an ack addressed back to
            # that seat would land in the other agent's packet queue
            # instead of completing this probe (seen at fleet scale —
            # adjacent attached seats starving each other's liveness).
            # Fall through to the next live non-external in-neighbor
            # rather than skipping the round, so a seat whose rotation
            # lands on attached neighbors still gets probed (its dead
            # agent must still be detectable).
            c0 = (t_now // g.probe_period_ticks) % topo.degree
            src = None
            for d in range(topo.degree):
                cand = (seat - int(off[(c0 + d) % topo.degree])) % n
                if self._alive(cand) and not self._external(cand):
                    src = cand
                    break
            if src is None:
                continue  # no live sim in-neighbor this tick
            self._seq += 1
            self._pending[seat] = (self._seq, t_now + g.probe_timeout_ticks)
            msgs = [codec.encode_message(
                MessageType.PING,
                {"SeqNo": self._seq, "Node": seat_name(seat)})]
            # Piggyback the source's hottest facts as gossip. The budgets
            # sort as the reference's int32 row does (numpy's argsort
            # breaks ties by dtype-specific paths).
            src_view = self._view_row(src)
            src_tx = self._tx_row(src).astype(np.int32)
            hot = np.argsort(-src_tx)[:g.piggyback_msgs]
            for c2 in hot:
                if src_tx[c2] <= 0:
                    continue
                subj = (src + int(off[c2])) % n
                key = int(src_view[c2])
                status = merge.key_status_int(key)
                mt = {merge.ALIVE: MessageType.ALIVE,
                      merge.SUSPECT: MessageType.SUSPECT,
                      merge.DEAD: MessageType.DEAD,
                      merge.LEFT: MessageType.DEAD}[status]
                body = {"Incarnation": merge.key_incarnation_int(key),
                        "Node": seat_name(subj)}
                if mt != MessageType.ALIVE:
                    body["From"] = seat_name(src)
                else:
                    body.update({"Addr": seat_name(subj).encode(),
                                 "Port": 7946, "Meta": b"",
                                 "Vsn": bytes(VSN)})
                msgs.append(codec.encode_message(mt, body))
            rtt = self._model_rtt(src, seat)
            self._deliver(seat, codec.encode_packet(msgs),
                          seat_addr(src), self.now() + rtt)

    def _emit_events(self, t_now: int):
        """The serf delegate's event feed for attached agents
        (GetBroadcasts piggyback, serf/delegate.go:19-282): every tick,
        scan a rotating in-neighbor's event queue and deliver any event
        the agent has not seen — the rotation visits all K in-neighbors
        within K ticks, well inside the dedup buffer's retention, so an
        epidemic that reached ANY in-neighbor reaches the agent. The
        sources' queue rows are gathered in one transfer."""
        n = self.sim.cfg.n
        k_deg = self._off.shape[0]
        srcs = {}
        for seat, tr in self.transports.items():
            if tr.down:
                continue
            src = (seat - int(self._off[t_now % k_deg])) % n
            if self._alive(src) and not self._left(src):
                srcs[seat] = src  # dead members never source event traffic
        if not srcs:
            return
        s = self.sim.state
        rows = sorted(set(srcs.values()))
        at = {r: i for i, r in enumerate(rows)}
        idx = torch.tensor(rows, dtype=torch.int64, device=s.ev_key.device)
        key_rows = (s.ev_key.view(torch.int32).index_select(0, idx).cpu()
                    .numpy().view(np.uint32).astype(np.int64))
        origin_rows = s.ev_origin.index_select(0, idx).cpu().numpy()
        self.stats["d2h_bytes"] += key_rows.nbytes // 2 + origin_rows.nbytes
        for seat, src in srcs.items():
            keys = key_rows[at[src]]
            origins = origin_rows[at[src]]
            seen = self._delivered_events.setdefault(seat, {})
            out = []
            for slot in range(keys.shape[0]):
                key = int(keys[slot])
                if key == 0 or key in seen:
                    continue  # empty or already delivered
                seen[key] = None
                while len(seen) > self._queue_max:
                    seen.pop(next(iter(seen)))
                name_int = (key >> 1) & 0xFF
                if key & 1:
                    # Query envelope (messageQueryType): the agent can
                    # respond with messageQueryResponse to the origin's
                    # address; Flags bit 0 requests a delivery ack.
                    q_name = self._query_names.get(
                        name_int, f"query-{name_int}")
                    self._bounded_insert(
                        self._known_queries, (q_name, key >> 9))
                    origin = int(origins[slot]) % n
                    timeout_ticks = serf_mod.query_timeout_ticks(
                        self.sim.cfg)
                    out.append(codec.encode_serf_message(
                        codec.SERF_QUERY, {
                            "LTime": key >> 9,
                            "ID": key,
                            "Addr": seat_name(origin).encode(),
                            "Port": 7946,
                            "Filters": [],
                            "Flags": 1,  # queryFlagAck
                            "RelayFactor": 0,
                            "Timeout": int(
                                timeout_ticks
                                * self.sim.cfg.gossip.tick_ms * 1e6),
                            "Name": q_name,
                            "Payload": self._query_payloads.get(
                                name_int, b""),
                        }))
                    continue
                # Mark the echo as known so the agent's re-gossip of it
                # cannot re-fire into the sim (bounded here too — this
                # insert site sees one entry per sim-originated event).
                ev_name = self._event_names.get(
                    name_int, f"evt-{name_int}")
                self._bounded_insert(
                    self._known_events, (ev_name, key >> 9))
                out.append(codec.encode_serf_message(
                    codec.SERF_USER_EVENT, {
                        "LTime": key >> 9,
                        "Name": ev_name,
                        "Payload": self._event_payloads.get(
                            name_int, b""),
                        "CC": True,
                    }))
            if out:
                rtt = self._model_rtt(src, seat)
                self._deliver(seat, codec.encode_packet(out),
                              seat_addr(src), self.now() + rtt)

    # ------------------------------------------------------------------
    # The per-tick host boundary
    # ------------------------------------------------------------------
    def step(self):
        """Process staged traffic both ways; call after each sim tick."""
        t_now = int(self.sim._t)
        self._prefetch(t_now)
        still = []
        for from_seat, to_seat, stream, deadline in self._pending_streams:
            if not self._serve_stream(from_seat, to_seat, stream) \
                    and t_now < deadline:
                still.append((from_seat, to_seat, stream, deadline))
        self._pending_streams = still
        self._emit_probes_and_gossip()
        if self._serf:
            self._emit_events(t_now)
        self._apply_staged()

    def _apply_staged(self):
        if self._stage_view or self._stage_inc or self._stage_coord \
                or self._stage_alive:
            self._edit_rows(
                [r for r, _, _ in self._stage_view]
                + list(self._stage_inc) + list(self._stage_coord)
                + list(self._stage_alive), self._staged_edit)
            self._stage_view = []
            self._stage_inc = {}
            self._stage_coord = {}
            self._stage_alive = {}
        if self._stage_fired and self._serf:
            # Fire the agents' user events into the sim event plane
            # (serf.UserEvent from the external seats' queues; the
            # event plane broadcasts them like any member's).
            n = self.sim.cfg.n
            by_name: dict[int, np.ndarray] = {}
            for seat, name_int in self._stage_fired:
                m = by_name.setdefault(name_int, np.zeros(n, bool))
                m[seat] = True
            for name_int, mask in by_name.items():
                self.sim.user_event(mask, name_int)
            self._stage_fired = []
        if self._stage_query and self._serf:
            # Agent-fired queries enter the device plane (serf.query);
            # the tracker learns the device-assigned key so responses
            # and the per-responder record stay correlated.
            n = self.sim.cfg.n
            for seat, name_int in self._stage_query:
                mask = np.zeros(n, bool)
                mask[seat] = True
                self.sim.query(mask, name_int)
                slot = serf_mod.newest_query_slot(self.sim.state, seat)
                key = int(self.sim.state.q_open_key[seat].to(torch.int64)[slot])
                rec = self._track_query(key >> 9, name_int)
                rec["origin_seat"] = seat
                rec["slot"] = slot
            self._stage_query = []
        if self._stage_qtally and self._serf:
            # Agent responses/acks to sim-origin queries land in the
            # device counters at (origin row, query slot) — one batched
            # accumulating index_put per kind.
            s = self.sim.state
            dev = s.q_acks.device
            for leaf, want in (("q_acks", False), ("q_resps", True)):
                hits = [(o, sl) for o, sl, is_resp in self._stage_qtally
                        if is_resp == want]
                if not hits:
                    continue
                r, c = zip(*hits)
                x = getattr(s, leaf)
                s = s._replace(**{leaf: x.index_put(
                    (torch.tensor(r, device=dev), torch.tensor(c, device=dev)),
                    torch.ones(len(r), dtype=x.dtype, device=dev),
                    accumulate=True)})
            self.sim.state = s
            self._stage_qtally = []

    def _staged_edit(self, st, local):
        """The staged view, incarnation, coordinate and liveness writes
        on the gathered dense rows (``local``: row id -> block index)."""
        dev = st.view_key.device
        i64 = torch.int64
        if self._stage_view:
            k = st.view_key.shape[1]
            flat = torch.tensor([local[r] * k + c
                                 for r, c, _ in self._stage_view],
                                dtype=i64, device=dev)
            keys = torch.tensor([key for _, _, key in self._stage_view],
                                dtype=i64, device=dev)
            old = st.view_key.reshape(-1)[flat]
            # Entries the join actually raised re-arm their gossip
            # budget, exactly as an in-sim delivery would (swim.step's
            # end-of-tick changed-detection can't see writes staged
            # between ticks, so the bridge is responsible for queueing
            # the rebroadcast — queue.go:182-242 semantics).
            tx0 = int(scaling.retransmit_limit(
                self.sim.cfg.gossip.retransmit_mult, self.sim.cfg.n))
            changed = keys > old
            st = st._replace(
                view_key=st.view_key.reshape(-1).scatter_reduce(
                    0, flat, keys, "amax").view_as(st.view_key),
                tx_left=st.tx_left.reshape(-1).scatter_reduce(
                    0, flat, torch.where(changed, tx0, 0).to(i64),
                    "amax").view_as(st.tx_left),
            )
        if self._stage_inc:
            rows = torch.tensor([local[r] for r in self._stage_inc],
                                dtype=i64, device=dev)
            incs = torch.tensor(list(self._stage_inc.values()), dtype=i64,
                                device=dev)
            st = st._replace(own_inc=st.own_inc.scatter_reduce(
                0, rows, incs, "amax"))
        if self._stage_coord:
            v = st.viv
            vec, h = v.vec.clone(), v.height.clone()
            err, adj = v.error.clone(), v.adjustment.clone()
            for seat, c in self._stage_coord.items():
                i = local[seat]
                vec[i] = torch.tensor(c["Vec"], dtype=torch.float32)
                h[i] = c["Height"]
                err[i] = c["Error"]
                adj[i] = c["Adjustment"]
            st = st._replace(viv=v._replace(vec=vec, height=h,
                                            error=err, adjustment=adj))
        if self._stage_alive:
            alive = st.alive_truth.clone()
            for seat, up in self._stage_alive.items():
                alive[local[seat]] = up
            st = st._replace(alive_truth=alive)
        return st

    def query_status(self, origin_row: int,
                     qid: Optional[int] = None) -> Optional[dict]:
        """The consumer-facing view of a query fired by ``origin_row``
        (seat or sim node): the device plane's exactly-once aggregate
        counts plus the per-responder names and payload bytes collected
        from attached agents — the QueryResponse acks/responses
        channels a `consul exec`-style consumer reads (serf/query.go).
        ``qid`` selects one of the origin's concurrent queries (the
        [N, Q] slot axis); default is the most recently opened. None
        when the node has no open or tracked query."""
        if not self._serf:
            return None
        s = self.sim.state
        if qid is not None:
            slot = serf_mod.query_slot(s, origin_row, qid)
            key = qid if slot >= 0 else 0
        else:
            slot = serf_mod.newest_query_slot(s, origin_row)
            key = (int(s.q_open_key[origin_row].to(torch.int64)[slot])
                   if slot >= 0 else 0)
        rec = None
        if key:
            rec = self.query_tracker.get((key >> 9, (key >> 1) & 0xFF))
        else:  # closed: the freshest tracker entry for this origin
            if qid is not None:
                rec = self.query_tracker.get((qid >> 9, (qid >> 1) & 0xFF))
                if rec is None or rec.get("origin_seat") != origin_row:
                    return None
            else:
                for k in reversed(list(self.query_tracker)):
                    if self.query_tracker[k].get("origin_seat") == \
                            origin_row:
                        rec = self.query_tracker[k]
                        break
                if rec is None:
                    return None
            # The slot the closed query last owned still holds its
            # final tallies (until reuse).
            slot = rec.get("slot", 0)
        return {
            "open": bool(key),
            "acks_total": int(s.q_acks[origin_row, slot]),
            "responses_total": int(s.q_resps[origin_row, slot]),
            "agent_acks": list((rec or {}).get("acks", [])),
            "agent_responses": dict((rec or {}).get("responses", {})),
        }

    def run(self, ticks: int):
        """Advance sim + bridge together, one tick at a time (the
        external seam forces tick-granular host sync; pure-sim runs use
        the chunked runs of models/cluster.py instead)."""
        for _ in range(ticks):
            self.sim.run(1, chunk=1, with_metrics=False)
            self.step()


# The leaves a bridge edit can change (packed and dense names); the others
# are never written back.
_EDITED = frozenset((
    "flags", "own_inc", "view_inc", "meta", "alive_truth", "left",
    "external", "view_key", "tx_left", "vec", "height", "error", "adjustment"))


def _put_rows(tree, idx, sub):
    """``tree`` with its rows ``idx`` of the leaves in ``_EDITED`` replaced
    by ``sub``'s (fresh leaves; the input is not written)."""
    out = []
    for name, x, y in zip(tree._fields, tree, sub):
        if not isinstance(x, torch.Tensor):
            out.append(_put_rows(x, idx, y))
        elif x.dim() == 0 or name not in _EDITED:
            out.append(x)
        else:
            v = layout_mod.ROW_VIEWS.get(x.dtype)
            out.append(x.index_copy(0, idx, y) if v is None
                       else x.view(v).index_copy(0, idx, y.view(v))
                       .view(x.dtype))
    return type(tree)(*out)


def _unpacked(sw):
    return layout_mod.unpack(sw) if isinstance(
        sw, layout_mod.PackedSimState) else sw
