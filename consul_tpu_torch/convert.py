"""Carry the reference's state across into the port.

The functions here take the JAX package's ``SimState``, ``PackedSimState``,
``World`` and ``Topology`` (and the serving plane's ``Snapshot``,
``WriteState`` and ``WriteBatch``, and the raft tier's ``RaftState`` and
draw tables) as NamedTuples (or nested dicts) of **numpy
arrays** — ``jax.tree.map(np.asarray, x)`` gives that — and return the
port's tensors on a chosen device. This is the port's "weights carried
across": a test makes the state once with the reference, converts it,
and steps both. No JAX is imported here; bfloat16 and float8 arrays are
read through their raw bits.
"""

from __future__ import annotations

import numpy as np
import torch

from consul_tpu_torch.models import layout, state as sim_state
from consul_tpu_torch.ops import topology, vivaldi

# numpy dtypes torch cannot read directly, by dtype name -> (raw-bit
# numpy view, torch dtype to reinterpret the bits as).
_BIT_VIEWS = {
    "bfloat16": (np.uint16, torch.bfloat16),
    "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
}


def _get(src, name):
    return src[name] if isinstance(src, dict) else getattr(src, name)


def tensor(arr, device="cpu", dtype=None) -> torch.Tensor:
    """numpy array (any reference dtype) -> tensor; ``dtype`` widens it."""
    arr = np.asarray(arr)
    view = _BIT_VIEWS.get(arr.dtype.name)
    if view is not None:
        t = torch.from_numpy(np.array(arr, copy=True).view(view[0])).view(view[1])
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def bits(t: torch.Tensor) -> np.ndarray:
    """Tensor -> numpy, with bfloat16/float8 as their raw bits (for
    bit-for-bit comparison with the reference's arrays)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def ref_bits(arr) -> np.ndarray:
    """Reference numpy array -> numpy, bfloat16/float8 as raw bits."""
    arr = np.asarray(arr)
    view = _BIT_VIEWS.get(arr.dtype.name)
    return arr.view(view[0]) if view is not None else arr


def sim_state_from(src, device="cpu") -> sim_state.SimState:
    """Reference dense SimState -> port SimState (ints widened to int64)."""
    i64 = torch.int64
    viv = _get(src, "viv")
    ints = {f: tensor(_get(src, f), device, i64) for f in (
        "t", "own_inc", "own_tx", "awareness", "probe_perm", "probe_ptr",
        "next_probe_tick", "pending_col", "pending_fail_tick",
        "pending_nack_miss", "view_key", "susp_start", "susp_seen", "tx_left",
        "lat_cnt")}
    bools = {f: tensor(_get(src, f), device, torch.bool) for f in (
        "alive_truth", "left", "leaving", "external")}
    return sim_state.SimState(
        **ints, **bools,
        lat_buf=tensor(_get(src, "lat_buf"), device, torch.float32),
        viv=vivaldi.VivaldiState(
            vec=tensor(_get(viv, "vec"), device, torch.float32),
            height=tensor(_get(viv, "height"), device, torch.float32),
            error=tensor(_get(viv, "error"), device, torch.float32),
            adjustment=tensor(_get(viv, "adjustment"), device, torch.float32),
            adj_samples=tensor(_get(viv, "adj_samples"), device, torch.float32),
            adj_idx=tensor(_get(viv, "adj_idx"), device, i64),
            resets=tensor(_get(viv, "resets"), device, i64),
        ),
    )


def packed_state_from(src, device="cpu") -> layout.PackedSimState:
    """Reference PackedSimState -> port PackedSimState, dtype for dtype."""
    viv = _get(src, "viv")
    return layout.PackedSimState(
        *[tensor(_get(src, f), device) for f in layout.PackedSimState._fields[:-1]],
        layout.PackedVivaldi(*[tensor(_get(viv, f), device)
                               for f in layout.PackedVivaldi._fields]))


def world_from(src, device="cpu") -> topology.World:
    return topology.World(pos=tensor(_get(src, "pos"), device, torch.float32),
                          height=tensor(_get(src, "height"), device, torch.float32))


def topology_from(src, device="cpu") -> topology.Topology:
    """Reference Topology -> port Topology (sparse tables rebuilt from the
    offsets and checked against the reference's)."""
    n, dense = int(_get(src, "n")), bool(_get(src, "dense"))
    off = np.asarray(_get(src, "off"), dtype=np.int64)
    if dense:
        return topology.Topology(
            n=n, dense=True, off=torch.as_tensor(off, device=device),
            rcol=None, inv=None, off_host=tuple(int(x) for x in off))
    topo = topology.topology_from_offsets(n, off, device)
    for name in ("rcol", "inv"):
        if not np.array_equal(np.asarray(_get(src, name)),
                              getattr(topo, name).cpu().numpy()):
            raise ValueError(f"reference topology {name} disagrees with the "
                             "tables rebuilt from its offsets")
    return topo


def serf_state_from(src, device="cpu"):
    """Reference SerfState (dense or packed SWIM plane) -> port SerfState:
    the SWIM plane through :func:`sim_state_from` or
    :func:`packed_state_from`, the serf leaves dtype for dtype."""
    from consul_tpu_torch.models import serf

    sw = _get(src, "swim")
    packed = ("flags" in sw) if isinstance(sw, dict) else hasattr(sw, "flags")
    swim = packed_state_from(sw, device) if packed else sim_state_from(sw, device)
    return serf.SerfState(swim, *[tensor(_get(src, f), device)
                                  for f in serf.SerfState._fields[1:]])


def schedule_from(src, device="cpu"):
    """Reference ChaosSchedule (numpy leaves) -> the port's ChaosSchedule
    on ``device``, dtype for dtype (int32 ticks, float32 rates, bool
    masks)."""
    from consul_tpu_torch.chaos import schedule as chaos

    return chaos.ChaosSchedule(*[tensor(_get(src, f), device)
                                 for f in chaos.ChaosSchedule._fields])


def snapshot_from(src, device="cpu"):
    """Reference serving Snapshot (numpy leaves) -> the port's Snapshot on
    ``device``: float32 coordinates, bool masks, int32 labels and a 0-d
    int32 tick."""
    from consul_tpu_torch.ops import serving

    f32, b = torch.float32, torch.bool
    return serving.Snapshot(
        vec=tensor(_get(src, "vec"), device, f32),
        height=tensor(_get(src, "height"), device, f32),
        adjustment=tensor(_get(src, "adjustment"), device, f32),
        known=tensor(_get(src, "known"), device, b),
        live=tensor(_get(src, "live"), device, b),
        service=tensor(_get(src, "service"), device, torch.int32),
        tick=tensor(_get(src, "tick"), device, torch.int32))


def write_state_from(src, device="cpu"):
    """Reference WriteState (numpy leaves) -> the port's WriteState on
    ``device``, dtype for dtype (int32 labels, sessions, KV words and
    index; bool masks)."""
    from consul_tpu_torch.ops import deltas

    return deltas.WriteState(*[tensor(_get(src, f), device)
                               for f in deltas.WriteState._fields])


def write_batch_from(src, device="cpu"):
    """Reference WriteBatch (numpy leaves) -> the port's int32 WriteBatch
    on ``device``."""
    from consul_tpu_torch.ops import deltas

    return deltas.WriteBatch(*[tensor(_get(src, f), device, torch.int32)
                               for f in deltas.WriteBatch._fields])


def raft_state_from(src, device="cpu"):
    """Reference RaftState (numpy leaves) -> the port's RaftState on
    ``device``, dtype for dtype (int32, bool ``log_client``)."""
    from consul_tpu_torch.ops import raft_ops

    return raft_ops.RaftState(*[tensor(_get(src, f), device)
                                for f in raft_ops.RaftState._fields])


def raft_draws_from(table, device="cpu") -> torch.Tensor:
    """A reference ``raft_ops.draw_table`` / ``timeout_draws`` table
    ([R, P] numpy) -> the port's int32 draw tensor on ``device`` (what
    ``raft_ops.tick`` and ``raft_ops.init`` take)."""
    return tensor(table, device, torch.int32)


def _take(tree, i):
    """Entry ``i`` along the leading axis of every leaf of a (nested)
    NamedTuple or dict of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_take(x, i) for x in tree])
    return np.asarray(tree)[i]


def federation_state_from(src, device="cpu"):
    """Reference FederationState (numpy leaves: the dense LAN SimState
    stacked [n_dc, ...], the dense WAN SimState, the Bresenham
    accumulator) -> the port's FederationState: n_dc packed LAN states,
    the packed WAN state and the accumulator as a Python int."""
    from consul_tpu_torch.models import federation

    lan = _get(src, "lan")
    n_dc = np.asarray(_get(lan, "t")).shape[0]
    return federation.FederationState(
        lan=tuple(layout.pack(sim_state_from(_take(lan, i), device))
                  for i in range(n_dc)),
        wan=layout.pack(sim_state_from(_get(src, "wan"), device)),
        wan_accum_ms=int(np.asarray(_get(src, "wan_accum_ms"))))


def lan_worlds_from(src, device="cpu") -> list:
    """The reference federation's stacked LAN World ([n_dc, N, D] and
    [n_dc, N] numpy) -> one port World per DC."""
    n_dc = np.asarray(_get(src, "pos")).shape[0]
    return [world_from(_take(src, i), device) for i in range(n_dc)]


def federation_kw(jfed, device="cpu") -> dict:
    """The keyword arguments that start a port ``Federation`` from a
    reference one (its attributes as numpy trees): the shared LAN and WAN
    topologies, the per-DC LAN worlds, the WAN world and the state."""
    return dict(
        lan_topo=topology_from(_get(jfed, "lan_topo"), device),
        wan_topo=topology_from(_get(jfed, "wan_topo"), device),
        lan_world=lan_worlds_from(_get(jfed, "lan_world"), device),
        wan_world=world_from(_get(jfed, "wan_world"), device),
        state=federation_state_from(_get(jfed, "state"), device))


def on_mesh(tree, mesh, n: int) -> list:
    """A port tree (a reference state converted by the functions above, a
    World, a draw bundle) placed on a node-axis mesh: one copy per shard,
    its rows of every node-axis leaf on its device (parallel/mesh.split),
    as the reference's ``shard_step.place`` places a state."""
    from consul_tpu_torch.parallel import mesh as mesh_mod

    return mesh_mod.split(mesh, tree, n)


def gathered(blocks: list, n: int, device="cpu"):
    """The whole state back from its shards' blocks, on ``device``, for
    comparison with the reference's gathered arrays (``bits`` reads its
    leaves)."""
    from consul_tpu_torch.parallel import mesh as mesh_mod

    return mesh_mod.join(blocks, n, device)
