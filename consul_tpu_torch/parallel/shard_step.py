"""Node-sharded execution of the gossip tick over a mesh (PyTorch port of
``consul_tpu/parallel/shard_step.py``).

The reference runs its step under ``shard_map``: one program per device
over a block of rows, every cross-node exchange an explicit collective.
The port keeps its single controller and runs the same split two ways.

- **The plain step, SPMD in threads** (:func:`run_ticks`): one thread per
  shard runs the port's own ``swim.step_counted`` / ``serf.step_counted``
  (through ``cuda_gossip.plain_tick`` / ``plain_serf_tick`` on the packed
  layout) on its block, inside ``collective.node_axis``, and the
  primitives of parallel/collective.py exchange rows through the shards'
  board, as ``torch.nn.parallel.parallel_apply`` runs one module per
  device.
- **The kernel (B7)** needs no threads: ``cuda_gossip.ShardedTickKernel``
  walks the tick's launches once per device group (a run of shards on
  one device, ``mesh.device_groups``), whose shards' blocks are adjacent
  row views of one storage per leaf (:func:`place`), so a group launches
  over its rows as one block. On one card that is one launch set, the
  one-device tick's; between groups the rows a launch reads are copied
  into each group's full-height buffers before it.

Each tick the controller draws the one-device bundle once from the
simulation's generator (on the plain path shard 0's thread makes that
draw and shares it) and every shard takes its rows, so a sharded run is
bit-equal to one device. Counters are per-shard (per-group on the
kernel) sums, added once per chunk; metrics are sampled once per chunk on
the final state with the RMSE pairs of the one-device runner's last row
(a length-1 ``TickTrace``): launch M reads the group's storage in place
where one group holds every shard on the mesh's first device, and a
gathered copy otherwise.

The planes that ride the tick: the raft tier (:class:`RaftArm`, placed
over the mesh and stepped by ``Simulation`` after the chunk's ticks, once
per device group, or once on the first device when replicated) and the
sweep's lanes (:func:`place_lanes`,
``ShardedChunkRunner.run_lanes``: every lane a placed copy of the state,
tick outer, lane inner).
"""

from __future__ import annotations

import threading
from typing import Callable

import torch

from consul_tpu_torch.chaos import schedule as chaos_mod
from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models import counters as counters_mod
from consul_tpu_torch.models import layout as layout_mod
from consul_tpu_torch.models import serf, swim
from consul_tpu_torch.ops import cuda_gossip, raft_ops
from consul_tpu_torch.ops.topology import Topology
from consul_tpu_torch.parallel import collective as coll
from consul_tpu_torch.parallel import mesh as mesh_mod

TORCH, CUDA = cuda_gossip.TORCH, cuda_gossip.CUDA


def place(mesh: mesh_mod.Mesh, tree, n: int, groups=None) -> list:
    """``tree`` placed on the mesh: each shard's rows of every node-axis
    leaf as adjacent views of one storage per device group (the leaves
    the sharded tick reads at other rows full height,
    ``cuda_gossip.full_height_leaves``), every other leaf whole. A copy."""
    return mesh_mod.split(mesh, tree, n, groups=groups,
                          full=cuda_gossip.full_height_leaves(tree))


def adjoin(mesh: mesh_mod.Mesh, blocks: list, n: int, groups=None) -> list:
    """Per-shard state blocks (each edited on its own) copied into the
    placement :func:`place` makes."""
    return mesh_mod.adjoin(blocks, mesh, n, groups=groups,
                           full=cuda_gossip.full_height_leaves(blocks[0]))


def place_schedule(mesh: mesh_mod.Mesh, sched, n: int, groups=None) -> list:
    """A fault schedule placed per shard: its node masks by row block
    (adjacent per device group), every per-entry leaf whole (the
    reference's shard_step.py:68-75)."""
    return mesh_mod.split(mesh, sched, n, groups=groups,
                          rows=chaos_mod.NODE_MASKS)


def place_lanes(mesh: mesh_mod.Mesh, blocks: list, lanes: int, n: int,
                groups=None) -> list:
    """``lanes`` copies of a placed state (:func:`place`), each placed as
    the state is: every lane holds its own rows of every shard's block,
    adjacent per device group (the reference's ``place_sweep``, whose
    ``sweep_spec`` shards the node dim of a [S, N, ...] leaf and
    replicates the scenario axis: here the lanes are a list)."""
    return [adjoin(mesh, blocks, n, groups=groups) for _ in range(lanes)]


def gather(blocks: list, n: int, device):
    """The whole state from its shards' blocks, on ``device``."""
    return mesh_mod.join(blocks, n, device)


def topo_on(topo: Topology, device) -> Topology:
    """The topology's tables on ``device``."""
    def mv(x):
        return None if x is None else x.to(device)
    return topo._replace(off=mv(topo.off), rcol=mv(topo.rcol), inv=mv(topo.inv))


def run_shards(mesh: mesh_mod.Mesh, n: int, fn: Callable, args: list) -> list:
    """``fn(shard, *args[shard])`` in one thread per shard, each inside
    ``collective.node_axis`` with the shards' board and on its mesh
    device. A shard that raises breaks the board's barrier for all of them
    and its exception is re-raised here; returns the results in shard
    order."""
    r = mesh.size
    mesh_mod.check_rows(n, r)
    board = coll.ShardBoard(r)
    results, errors = [None] * r, [None] * r

    def work(d):
        dev = mesh.devices[d]
        try:
            with coll.node_axis(r, n, d, board):
                if dev.type == "cuda":
                    with torch.cuda.device(dev):
                        results[d] = fn(d, *args[d])
                else:
                    results[d] = fn(d, *args[d])
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors[d] = e
            board.abort()

    threads = [threading.Thread(target=work, args=(d,), daemon=True,
                                name=f"shard-{d}") for d in range(r)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    # The first failure that is not another shard's broken barrier.
    first = next((e for e in errors if e is not None
                  and not isinstance(e, coll.ShardAborted)), None)
    first = first or next((e for e in errors if e is not None), None)
    if first is not None:
        raise first
    return results


def _shared_draw(d: int, draw, t: int):
    """The controller's draw of tick ``t``, made on shard 0's thread and
    handed to every shard through the board."""
    ctx = coll.current()
    bundle = draw(t) if d == 0 else None
    return ctx.board.exchange(d, bundle)[0]


class RaftArm:
    """The raft tier on a mesh (reference shard_step.py:236-244, :270-289,
    :333-345), with the reference's two layouts of the ``[R, ...]``
    RaftState leaves:

    - **group-sharded** when the mesh's shards divide ``R``: shard d holds
      the groups ``[d * R / S, (d + 1) * R / S)``, placed as the node
      blocks are (``mesh.split`` over the group axis: adjacent views of
      one storage per device group), and each device group steps its own
      groups in one call with ``group0`` its first global group, so a raft
      entry of a schedule hits the shard that holds its group;
    - **replicated** otherwise: one copy on the mesh's first device,
      stepped once (the reference steps a copy per shard and zeroes the
      tallies off shard 0 before its psum; one copy tallies once).

    Each tick's ``[R, P]`` draws are made once, whole, and sliced by global
    group, so both layouts are bit-equal to one device."""

    def __init__(self, rcfg, mesh: mesh_mod.Mesh, groups=None):
        self.rcfg, self.mesh = rcfg, mesh
        self.groups = mesh_mod.check_groups(mesh, groups)
        self.sharded = rcfg.groups % mesh.size == 0
        # Raft groups per shard (all of them when replicated).
        self.rows = rcfg.groups // mesh.size if self.sharded else rcfg.groups
        self.device = mesh.devices[0]

    def place(self, rst) -> object:
        """A whole RaftState placed: per-shard blocks (group-sharded) or
        one copy on the first device (replicated). A copy."""
        if self.sharded:
            return mesh_mod.split(self.mesh, rst, self.rcfg.groups,
                                  groups=self.groups)
        return type(rst)(*(x.to(self.device, copy=True) for x in rst))

    def whole(self, placed):
        """The whole RaftState on the first device (a gather when sharded)."""
        if self.sharded:
            return mesh_mod.join(placed, self.rcfg.groups, self.device)
        return placed

    def parts(self, placed) -> list:
        """``[(shard, group0, tree)]``: one RaftState per device group, a
        view of its shards' adjacent blocks, with its first shard and first
        global group (one part, the copy, when replicated)."""
        if not self.sharded:
            return [(0, 0, placed)]
        return [(g[0], g[0] * self.rows, mesh_mod.group_tree(
            placed, g, self.rows, self.rcfg.groups)) for g in self.groups]

    def unparts(self, trees: list):
        """The placement of the parts' trees (in :meth:`parts` order)."""
        if not self.sharded:
            return trees[0]
        out = []
        for g, tree in zip(self.groups, trees):
            # The tick may hand back a strided leaf; the views need rows.
            tree = type(tree)(*(x.contiguous() for x in tree))
            out += mesh_mod.shard_views(tree, g, self.rows)
        return out

    def _step_part(self, shard: int, group0: int, tree, t: int, draws,
                   sched_blocks):
        """One raft tick of one part: its rows of the tick's whole draws,
        the schedule's raft entries from its shard's block."""
        rows = tree.term.shape[0]
        dev = tree.term.device
        sched = None if sched_blocks is None else sched_blocks[shard]
        return raft_ops.tick(self.rcfg, tree, t,
                             draws[group0:group0 + rows].to(dev), sched,
                             group0=group0)

    def step(self, placed, t: int, draws, sched_blocks=None):
        """One raft tick of every part (tick ``t``, its whole ``[R, P]``
        draws): the new placement and the tick's [8] int32 counters on the
        first device."""
        trees, total = [], None
        for shard, group0, tree in self.parts(placed):
            tree, rc = self._step_part(shard, group0, tree, t, draws,
                                       sched_blocks)
            trees.append(tree)
            v = raft_ops.counters_stack(rc).to(self.device)
            total = v if total is None else total + v
        return self.unparts(trees), total

    def summary(self, placed) -> tuple:
        """``raft_ops.summary`` of the placed state: each part's rows, in
        group order, on the first device."""
        cols = [raft_ops.summary(tree) for _, _, tree in self.parts(placed)]
        return tuple(torch.cat([c[i].to(self.device) for c in cols])
                     for i in range(4))

    def bump(self, placed, bumps: torch.Tensor):
        """``next_seq += bumps`` (an [R] int32 tensor on the first
        device), part by part."""
        trees = []
        for _, group0, tree in self.parts(placed):
            rows = tree.next_seq.shape[0]
            trees.append(tree._replace(next_seq=tree.next_seq + bumps[
                group0:group0 + rows].to(tree.next_seq.device)))
        return self.unparts(trees)


def run_ticks(mesh: mesh_mod.Mesh, n: int, tick: Callable, topos: dict,
              world_blocks, state_blocks, sched_blocks, draw: Callable,
              t0: int, ticks: int):
    """The plain sharded step: ``ticks`` ticks of ``tick(topo, world,
    state, draws, sched) -> (state, counters [26] int32)`` on each shard's
    block, one thread per shard (:func:`run_shards`), tick ``t``'s global
    bundle ``draw(t)`` made once and sliced per shard. Returns the blocks
    and the counters summed over the ticks and the shards
    (``collective.tree_psum``), on shard 0's device."""
    r = mesh.size
    scheds = sched_blocks if sched_blocks is not None else [None] * r

    def one(d, world_d, state_d, sched_d):
        dev = mesh.devices[d]
        cnt = torch.zeros((len(counters_mod.FIELDS),), dtype=torch.int32,
                          device=dev)
        for k in range(ticks):
            dd = mesh_mod.block_of(_shared_draw(d, draw, t0 + k), n, d, r, dev)
            state_d, c = tick(topos[dev], world_d, state_d, dd, sched_d)
            cnt = cnt + c
        return state_d, coll.tree_psum(cnt)

    out = run_shards(mesh, n, one, list(zip(world_blocks, state_blocks, scheds)))
    return [o[0] for o in out], out[0][1]


def _make_sharded(step_fn, cfg: SimConfig, topo: Topology,
                  mesh: mesh_mod.Mesh, counted: bool = False,
                  chaos: bool = False, sentinel: bool = False):
    """``step(world_blocks, [sched_blocks,] state_blocks, draws)``: one
    tick of ``step_fn`` on each shard's dense block (:func:`run_ticks`);
    with ``counted`` also the GossipCounters summed over the shards."""
    mesh_mod.check_rows(cfg.n, mesh.size)
    topos = {dev: topo_on(topo, dev) for dev in mesh.unique_devices()}

    def tick(topo_d, w, s, d, sched):
        s, c = step_fn(cfg, topo_d, w, s, d, sched=sched, sentinel=sentinel)
        return s, counters_mod.stack(c)

    def run(world_blocks, sched_blocks, state_blocks, draws):
        states, cnt = run_ticks(mesh, cfg.n, tick, topos, world_blocks,
                                state_blocks, sched_blocks, lambda _t: draws,
                                0, 1)
        return (states, counters_mod.unstack(cnt)) if counted else states

    if chaos:
        return run
    return lambda world_blocks, state_blocks, draws: run(
        world_blocks, None, state_blocks, draws)


def make_sharded_step(cfg: SimConfig, topo: Topology, mesh: mesh_mod.Mesh):
    """``step(world_blocks, state_blocks, draws) -> state_blocks``: the SWIM
    tick on each shard's dense ``SimState`` block."""
    return _make_sharded(swim.step_counted, cfg, topo, mesh)


def make_sharded_serf_step(cfg: SimConfig, topo: Topology,
                           mesh: mesh_mod.Mesh):
    """The full serf tick (SWIM + events, queries, reap) per shard; beyond
    the rolls, the origin reads ride ``all_rows`` and the query tally
    ``sum_scatter_rows``."""
    return _make_sharded(serf.step_counted, cfg, topo, mesh)


def make_sharded_counted_step(cfg: SimConfig, topo: Topology,
                              mesh: mesh_mod.Mesh, sentinel: bool = False):
    """``step(world_blocks, state_blocks, draws) -> (state_blocks,
    GossipCounters)``, the counters summed over the shards."""
    return _make_sharded(swim.step_counted, cfg, topo, mesh, counted=True,
                         sentinel=sentinel)


def make_sharded_counted_serf_step(cfg: SimConfig, topo: Topology,
                                   mesh: mesh_mod.Mesh):
    """The counted serf tick per shard (see :func:`make_sharded_counted_step`)."""
    return _make_sharded(serf.step_counted, cfg, topo, mesh, counted=True)


def make_sharded_chaos_step(cfg: SimConfig, topo: Topology,
                            mesh: mesh_mod.Mesh, *, counted: bool = False,
                            serf_plane: bool = False, sentinel: bool = False):
    """``step(world_blocks, sched_blocks, state_blocks, draws)`` with a
    fault schedule placed per shard (``chaos.schedule.place``): node masks
    by block, per-entry scalars whole."""
    fn = serf.step_counted if serf_plane else swim.step_counted
    return _make_sharded(fn, cfg, topo, mesh, counted=counted, chaos=True,
                         sentinel=sentinel)


class ShardedChunkRunner:
    """The counterpart of the reference's ``make_sharded_chunk_runner``:
    ``run(blocks, draw, t0, ticks, sched_blocks=None, pairs=None) ->
    (blocks, counters [26] int32, TickTrace or None)``.

    ``blocks`` are the shards' packed states (placed by :func:`place`
    under ``groups``), ``draw(t)`` the tick's global bundle on the mesh's
    first device, ``pairs`` the (i, j) RMSE pairs of the chunk's last tick
    (metrics off when None). ``kernel="cuda"`` steps through B7
    (``cuda_gossip.ShardedTickKernel``, one launch set per device group of
    ``groups``, by default ``mesh.device_groups``); ``kernel="torch"``
    runs the plain tick SPMD in threads. The counters are summed once, at
    the end of the chunk, on the first device.

    :meth:`run_lanes` is the sweep runner (the reference's
    ``make_sharded_sweep_runner``)."""

    def __init__(self, cfg: SimConfig, topo: Topology, mesh: mesh_mod.Mesh,
                 world, *, serf_plane: bool = False, sentinel: bool = False,
                 kernel: str = TORCH, groups=None):
        n = cfg.n
        mesh_mod.check_rows(n, mesh.size)
        for dev in mesh.unique_devices():
            cuda_gossip.validate_kernel(kernel, layout_mod.PACKED, dev)
        self.cfg, self.topo, self.mesh = cfg, topo, mesh
        self.serf, self.sentinel, self.kernel = serf_plane, sentinel, kernel
        self.device = mesh.devices[0]
        self.world = world
        self.groups = mesh_mod.check_groups(mesh, groups)
        self.world_blocks = place(mesh, world, n, groups=self.groups)
        self.topos = {dev: topo_on(topo, dev) for dev in mesh.unique_devices()}
        if kernel == CUDA:
            self._tick = cuda_gossip.ShardedTickKernel(
                cfg, topo, mesh, serf_plane=serf_plane, sentinel=sentinel,
                groups=self.groups)
            self._tick.set_world(world)
            self._metrics = cuda_gossip.make_metrics_kernel(
                cfg, self.topos[self.device])

    def _plain(self):
        cfg, sentinel = self.cfg, self.sentinel
        plain = cuda_gossip.plain_serf_tick if self.serf else cuda_gossip.plain_tick

        def tick(topo, w, s, d, sched):
            return plain(cfg, topo, w, s, d, sched, sentinel)
        return tick

    def _run_plain(self, blocks, draw, t0, ticks, sched_blocks):
        blocks, cnt = run_ticks(self.mesh, self.cfg.n, self._plain(),
                                self.topos, self.world_blocks, blocks,
                                sched_blocks, draw, t0, ticks)
        return blocks, cnt.to(self.device)

    def _sum(self, cv):
        total = cv[0]
        for c in cv[1:]:
            total = total + c.to(total.device)
        return total

    def _run_kernel(self, blocks, draw, t0, ticks, sched_blocks):
        cnt = None
        for k in range(ticks):
            blocks, cv = self._tick(blocks, draw(t0 + k), sched_blocks)
            cv = self._sum(cv)
            cnt = cv if cnt is None else cnt + cv
        return blocks, cnt

    def metrics(self, blocks, pairs):
        """[4] float32 TickTrace row of the whole state: launch M on the
        card under ``kernel="cuda"`` (over the group's storage in place
        where one group holds every shard), its plain version otherwise
        (over a gathered copy)."""
        planes = [b.swim if self.serf else b for b in blocks]
        if self.kernel == CUDA and len(self.groups) == 1:
            whole = mesh_mod.group_tree(planes, self.groups[0],
                                        self.cfg.n // self.mesh.size, self.cfg.n)
        else:
            whole = gather(planes, self.cfg.n, self.device)
        i, j = pairs
        if self.kernel == CUDA:
            out = torch.empty((4,), dtype=torch.float32, device=self.device)
            return self._metrics(self.world, whole, i, j, out)
        return cuda_gossip.plain_metrics(self.cfg, self.topos[self.device],
                                         self.world, whole, i, j)

    def run(self, blocks, draw, t0: int, ticks: int, sched_blocks=None,
            pairs=None):
        if sched_blocks is not None and chaos_mod.or_none(sched_blocks[0]) is None:
            sched_blocks = None
        run = self._run_kernel if self.kernel == CUDA else self._run_plain
        blocks, cnt = run(blocks, draw, t0, ticks, sched_blocks)
        if pairs is None:
            return blocks, cnt, None
        from consul_tpu_torch.models.cluster import TickTrace  # no cycle

        row = self.metrics(blocks, pairs)
        return blocks, cnt, TickTrace(*row[:, None])

    def run_lanes(self, lanes: list, draw, t0: int, ticks: int,
                  lane_scheds: list):
        """The sweep runner: ``ticks`` ticks of S lanes, tick outer and
        lane inner, every lane taking tick ``t``'s one bundle ``draw(t)``
        under its own schedule (placed by :func:`place_schedule` under
        ``groups``), each lane's blocks placed as a state is
        (:func:`place_lanes`). On the card each lane-tick is the
        schedule's B7 launch set; on the plain path one thread per shard
        steps every lane. Returns the lanes' blocks and their counters,
        [S, 26] int64 on the first device, summed exactly over the ticks
        and the shards (a 1M-node lane sends more than 2**31 messages
        within ~1,000 ticks)."""
        n_lanes, fields = len(lanes), len(counters_mod.FIELDS)
        if self.kernel == CUDA:
            cnt = torch.zeros((n_lanes, fields), dtype=torch.int64,
                              device=self.device)
            for k in range(ticks):
                d = draw(t0 + k)
                for s in range(n_lanes):
                    lanes[s], cv = self._tick(lanes[s], d, lane_scheds[s])
                    cnt[s] += self._sum(cv)
            return lanes, cnt
        tick, r, n = self._plain(), self.mesh.size, self.cfg.n

        def one(d, world_d, states, scheds):
            dev = self.mesh.devices[d]
            acc = torch.zeros((n_lanes, fields), dtype=torch.int64, device=dev)
            for k in range(ticks):
                dd = mesh_mod.block_of(_shared_draw(d, draw, t0 + k), n, d, r,
                                       dev)
                for s in range(n_lanes):
                    states[s], c = tick(self.topos[dev], world_d, states[s],
                                        dd, scheds[s])
                    acc[s] += c
            return states, acc

        out = run_shards(self.mesh, n, one, [
            (self.world_blocks[d], [blk[d] for blk in lanes],
             [sb[d] for sb in lane_scheds]) for d in range(r)])
        cnt = out[0][1].to(self.device)
        for o in out[1:]:
            cnt = cnt + o[1].to(self.device)
        new = [[out[d][0][s] for d in range(r)] for s in range(n_lanes)]
        return new, cnt


def make_sharded_chunk_runner(cfg: SimConfig, topo: Topology,
                              mesh: mesh_mod.Mesh, world, *,
                              serf_plane: bool = False, sentinel: bool = False,
                              kernel: str = TORCH,
                              groups=None) -> ShardedChunkRunner:
    """The sharded chunk runner (:class:`ShardedChunkRunner`)."""
    return ShardedChunkRunner(cfg, topo, mesh, world, serf_plane=serf_plane,
                              sentinel=sentinel, kernel=kernel, groups=groups)
