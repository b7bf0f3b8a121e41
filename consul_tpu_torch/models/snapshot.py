"""Serf gossip snapshot: an append-only member-event log and its replay
rejoin (PyTorch port of ``consul_tpu/models/snapshot.py``).

Mirrors the reference Snapshotter (serf/snapshot.go:59-431): each agent
streams its membership events and Lamport clock values to an append-only
file in the reference's exact line format

    alive: <name> <addr>\\n        (:328)
    not-alive: <name>\\n           (:336)
    clock: <n>\\n                  (:349)
    event-clock: <n>\\n            (:360)
    query-clock: <n>\\n            (:370)
    leave\\n                       (:274)

compacts the file once it outgrows ``min_compact_size`` (rewritten as the
current alive set and clock floors, :431-479, default 128 KiB), and on
restart replays it to recover the previously known alive nodes and clock
floors, which seed a *warm* rejoin (handleRejoin, serf.go:1705) instead of
the handful of join addresses a cold restart has.

Here the observer is one **monitored seat** of the simulated cluster: its
event stream is derived from its view row at chunk boundaries, one
device-to-host copy of that row and its three clocks per :meth:`observe`
call (the packed row's status bits, or the dense row's keys).
:func:`rejoin` is ``state.revive`` with the replayed knowledge: view
entries toward the recorded alive nodes start as contactable
``(0, ALIVE)`` join seeds, and the node's Lamport clocks are witnessed
forward to the recorded floors, so stale events never redeliver (the
eventMinTime guarantee, serf.go:1258-1357).
"""

from __future__ import annotations

import os

import torch

from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models import layout as layout_mod
from consul_tpu_torch.models import state as sim_state
from consul_tpu_torch.ops import lamport, merge


def _seat_name(i: int) -> str:
    return f"sim-{i}"


def _seat_row(state, node: int):
    """(statuses [K], (clock, event_clock, query_clock)) of ``node`` as
    Python ints, in one device-to-host copy. ``state`` is a SerfState with
    a dense or a packed SWIM plane."""
    sw = state.swim
    if layout_mod.is_packed(sw):
        # uint16 and uint32 have no indexing on the card: their bits as
        # int16 / int32.
        row = sw.meta.view(torch.int16)[node].to(torch.int64)
    else:
        row = sw.view_key[node].to(torch.int64)
    clocks = torch.stack([x.view(torch.int32)[node] for x in
                          (state.clock, state.event_clock, state.query_clock)])
    fetched = torch.cat([row, clocks.to(torch.int64)]).cpu().tolist()
    k = row.shape[0]
    statuses = [v & (merge.N_STATUS - 1) for v in fetched[:k]]
    return statuses, [v & 0xFFFFFFFF for v in fetched[k:]]


class Snapshotter:
    """Append-only event log for one monitored seat of the simulation."""

    def __init__(self, path: str, node: int,
                 min_compact_size: int = 128 * 1024,
                 rejoin_after_leave: bool = False):
        self.path = path
        self.node = node
        self.min_compact_size = min_compact_size
        self.rejoin_after_leave = rejoin_after_leave
        # Prime the transition state from the existing file, as the
        # reference replays on open: a reopened log keeps appending
        # transitions, and compaction never regresses clock floors.
        prior = replay(path, rejoin_after_leave=True)
        self._last_alive: dict[str, str] = dict(prior.alive)
        self._clocks = {"clock": prior.clock,
                        "event-clock": prior.event_clock,
                        "query-clock": prior.query_clock}
        self._off = None  # the topology's offsets, read once
        self._fh = open(path, "a", encoding="utf-8")
        self.offset = self._fh.tell()

    # -- recording -------------------------------------------------------
    def _append(self, line: str):
        self._fh.write(line)
        self._fh.flush()
        self.offset += len(line.encode())
        if self.offset > self.min_compact_size:
            self.compact()

    def observe(self, cfg: SimConfig, topo, serf_state) -> None:
        """Record the monitored seat's membership transitions and clock
        advances since the last call; call at chunk boundaries.

        The transition state is updated entry by entry *before* each
        append: ``_append`` can compact at any point, and compaction writes
        the current transition state (the reference's per-event order,
        snapshot.go:322-370)."""
        if self._off is None:
            self._off = list(topo.off_host) or topo.off.cpu().tolist()
        nd, n = self.node, cfg.n
        statuses, clocks = _seat_row(serf_state, nd)
        now_alive = {}
        for c, off in enumerate(self._off):
            j = (nd + int(off)) % n
            if statuses[c] == merge.ALIVE:
                now_alive[_seat_name(j)] = f"{_seat_name(j)}:7946"
        for name, addr in now_alive.items():
            if name not in self._last_alive:
                self._last_alive[name] = addr
                self._append(f"alive: {name} {addr}\n")
        for name in list(self._last_alive):
            if name not in now_alive:
                del self._last_alive[name]
                self._append(f"not-alive: {name}\n")
        for key, v in zip(("clock", "event-clock", "query-clock"), clocks):
            if v > self._clocks[key]:
                self._clocks[key] = v
                self._append(f"{key}: {v}\n")

    def leave(self):
        """Record an intentional departure: replay then starts from scratch
        unless ``rejoin_after_leave`` (snapshot.go:271-279)."""
        self._append("leave\n")

    def close(self):
        self._fh.close()

    # -- compaction (snapshot.go:431-479) --------------------------------
    def compact(self):
        tmp = self.path + ".compact"
        with open(tmp, "w", encoding="utf-8") as out:
            for name, addr in sorted(self._last_alive.items()):
                out.write(f"alive: {name} {addr}\n")
            out.write(f"clock: {self._clocks['clock']}\n")
            out.write(f"event-clock: {self._clocks['event-clock']}\n")
            out.write(f"query-clock: {self._clocks['query-clock']}\n")
        self._fh.close()
        os.replace(tmp, self.path)
        self._fh = open(self.path, "a", encoding="utf-8")
        self.offset = self._fh.tell()


class Replay:
    """State recovered from a snapshot file (snapshot.go's replay loop:
    alive / not-alive / clock / leave lines)."""

    def __init__(self, alive: dict[str, str], clock: int, event_clock: int,
                 query_clock: int, left: bool):
        self.alive = alive
        self.clock = clock
        self.event_clock = event_clock
        self.query_clock = query_clock
        self.left = left

    @property
    def previous_nodes(self) -> list[tuple[str, str]]:
        return sorted(self.alive.items())


def replay(path: str, rejoin_after_leave: bool = False) -> Replay:
    alive: dict[str, str] = {}
    clocks = {"clock": 0, "event-clock": 0, "query-clock": 0}
    left = False
    if os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if line.startswith("alive: "):
                    parts = line[len("alive: "):].rsplit(" ", 1)
                    if len(parts) == 2:
                        alive[parts[0]] = parts[1]
                elif line.startswith("not-alive: "):
                    alive.pop(line[len("not-alive: "):], None)
                elif line == "leave":
                    left = True
                    if not rejoin_after_leave:
                        alive.clear()
                        clocks = dict.fromkeys(clocks, 0)
                else:
                    for key in clocks:
                        if line.startswith(key + ": "):
                            try:
                                clocks[key] = max(clocks[key],
                                                  int(line[len(key) + 2:]))
                            except ValueError:
                                pass  # a torn tail line (crash mid-append)
                            break
    return Replay(alive, clocks["clock"], clocks["event-clock"],
                  clocks["query-clock"], left)


def rejoin(cfg: SimConfig, topo, serf_state, node: int, rep: Replay):
    """Warm restart of ``node`` from a replayed snapshot: revive with join
    seeds at every previously known alive neighbor, and witness the
    Lamport clocks forward to the recorded floors (handleRejoin
    serf.go:1705 and the clock recovery of snapshot.go). ``serf_state`` is
    a SerfState with a dense SWIM plane; so is the result."""
    s = serf_state
    n = cfg.n
    dev = s.clock.device
    mask = torch.arange(n, device=dev) == node
    off = list(topo.off_host) or topo.off.cpu().tolist()
    known = set(rep.alive)
    seed_cols = [c for c, o in enumerate(off)
                 if _seat_name((node + int(o)) % n) in known]
    if not seed_cols:
        # An empty replay (a fresh file, or a recorded leave without
        # rejoin_after_leave): fall back to the configured join addresses,
        # as the reference's restart without a usable snapshot is a plain
        # Join() (memberlist.go:228).
        return s._replace(swim=sim_state.revive(cfg, s.swim, mask, cold=True))
    # Cold wipe (the process restarted; its memory is the file), then seed
    # (0, ALIVE) toward every replayed alive node in the view.
    sw = sim_state.revive(cfg, s.swim, mask, cold=True, join_seeds=0)
    row = torch.full((len(off),), merge.UNKNOWN, dtype=sw.view_key.dtype,
                     device=dev)
    row[torch.tensor(seed_cols, device=dev)] = merge.make_key_int(0, merge.ALIVE)
    view = sw.view_key.clone()
    view[node] = row
    sw = sw._replace(view_key=view)

    def witness(arr, floor):
        return lamport.witness(arr, floor, mask).to(arr.dtype)

    # Elementwise: uint32 tensors take no indexing on the card.
    wide = s.ev_floor.to(torch.int64)
    ev_floor = torch.where(mask, torch.clamp(wide, min=int(rep.event_clock)),
                           wide).to(s.ev_floor.dtype)
    return s._replace(
        swim=sw,
        clock=witness(s.clock, rep.clock),
        event_clock=witness(s.event_clock, rep.event_clock),
        query_clock=witness(s.query_clock, rep.query_clock),
        ev_floor=ev_floor,
    )
