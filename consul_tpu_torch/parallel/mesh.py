"""Meshes of torch devices over the node axis (PyTorch port of
``consul_tpu/parallel/mesh.py``).

The reference shards the node axis of one simulated cluster over a
``jax.sharding.Mesh`` that one process drives (single-controller). The
port keeps that model: a :class:`Mesh` is an ordered list of torch
devices on one node axis (or a (dc, nodes) grid, flattened row-major),
and shard ``d`` owns the global rows ``[d * n / R, (d + 1) * n / R)`` as
tensors of its own on ``devices[d]``. A device may repeat, so several
shards can share one card (``["cuda:0"] * 4``) or the CPU
(``["cpu"] * 4``); every exchange between shards still copies, as it
would between cards (parallel/collective.py). NCCL and multi-process
placement are not part of this model: the reference has no
multi-controller path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

NODE_AXIS = "nodes"
DC_AXIS = "dc"


def as_device(d) -> torch.device:
    """``d`` as a torch device with its index filled in for CUDA."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Devices of a node-axis mesh, flattened row-major, and the grid's
    axes: ``(NODE_AXIS,)`` or ``(DC_AXIS, NODE_AXIS)``."""

    devices: tuple
    axis_names: tuple = (NODE_AXIS,)
    shape: tuple = ()

    def __post_init__(self):
        devs = tuple(as_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)
        if not self.shape:
            object.__setattr__(self, "shape", (len(devs),))
        size = 1
        for s in self.shape:
            size *= s
        if size != len(devs) or len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} over axes "
                             f"{self.axis_names} does not hold {len(devs)} "
                             "devices")

    @property
    def size(self) -> int:
        return len(self.devices)

    def unique_devices(self) -> list:
        """Each device once, in mesh order."""
        out = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out


def visible_devices() -> list:
    """Every visible CUDA device (none on a machine without one)."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def mesh_key(mesh: Optional[Mesh]):
    """Hashable fingerprint of a mesh: axis names, shape and the devices in
    order (type, index). ``None`` (one device, no mesh) is None."""
    if mesh is None:
        return None
    return (tuple(mesh.axis_names), tuple(mesh.shape),
            tuple((d.type, d.index) for d in mesh.devices))


def node_axes(mesh: Mesh):
    """(axis, n_shards) carrying the node dimension of a flat simulation:
    a 2-D (dc, nodes) grid shards the one node axis over both of its axes,
    row-major, so every device of the grid holds a block."""
    if DC_AXIS in mesh.axis_names:
        return (DC_AXIS, NODE_AXIS), mesh.size
    return NODE_AXIS, mesh.size


def make_mesh(devices: Optional[Sequence] = None, n_dc: int = 1) -> Mesh:
    """1-D node mesh, or 2-D (dc, nodes) when federating datacenters.
    ``devices`` defaults to every visible CUDA device and may repeat a
    device."""
    devices = list(devices if devices is not None else visible_devices())
    if n_dc == 1:
        return Mesh(tuple(devices))
    if len(devices) % n_dc != 0:
        raise ValueError("devices must divide evenly into DCs")
    return Mesh(tuple(devices), (DC_AXIS, NODE_AXIS),
                (n_dc, len(devices) // n_dc))


def elastic_mesh(n: int, devices: Optional[Sequence] = None,
                 n_dc: int = 1) -> Mesh:
    """The largest mesh the surviving devices support: the biggest count
    k <= len(devices) that divides into ``n_dc`` datacenters and whose
    shards per DC divide ``n``. Always succeeds for ``n_dc=1``; raises when
    no subset can host ``n_dc`` DCs."""
    devices = list(devices if devices is not None else visible_devices())
    for k in range(len(devices), 0, -1):
        if k % n_dc == 0 and n % (k // n_dc or 1) == 0 and k >= n_dc:
            return make_mesh(devices[:k], n_dc=n_dc)
    raise ValueError(
        f"no usable mesh: {len(devices)} surviving device(s) cannot "
        f"host n={n} nodes across n_dc={n_dc} datacenters")


def default_mesh(n: int, device_count: Optional[int] = None, n_dc: int = 1,
                 devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """The largest elastic mesh the devices support, or ``None`` (one
    device, no mesh) when only one is visible or ``device_count`` pins one.
    ``devices`` defaults to every visible CUDA device; ``device_count``
    truncates it."""
    devices = list(devices if devices is not None else visible_devices())
    if device_count is not None:
        if device_count < 1:
            raise ValueError(f"device_count={device_count} must be >= 1")
        devices = devices[:device_count]
    if len(devices) <= 1 and n_dc <= 1:
        return None
    return elastic_mesh(n, devices, n_dc=n_dc)


def check_rows(n: int, n_shards: int) -> int:
    """Rows per shard; ``n`` must divide over the shards."""
    if n % n_shards != 0:
        raise ValueError(f"n={n} must divide over {n_shards} shards")
    return n // n_shards


def is_row_leaf(leaf, n: int) -> bool:
    """The one node-axis rule: a leaf whose leading dim is the node count
    splits by row block; every other leaf replicates."""
    return isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 and \
        leaf.shape[0] == n


def _rebuild(tree, items):
    """A tuple, list or NamedTuple like ``tree`` holding ``items``."""
    items = list(items)
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def _map(fn, tree):
    if tree is None or isinstance(tree, torch.Tensor):
        return fn(tree)
    return _rebuild(tree, (_map(fn, x) for x in tree))


def block_of(tree, n: int, shard: int, n_shards: int, device):
    """Shard ``shard``'s copy of ``tree`` on ``device``: its rows of every
    node-axis leaf, every other leaf whole. Always a copy."""
    b = check_rows(n, n_shards)

    def take(x):
        if x is None:
            return None
        if is_row_leaf(x, n):
            x = x[shard * b:(shard + 1) * b]
        return x.to(device, copy=True)
    return _map(take, tree)


def split(mesh: Mesh, tree, n: int) -> list:
    """Place a tree on the mesh: one copy per shard (:func:`block_of`)."""
    return [block_of(tree, n, d, mesh.size, dev)
            for d, dev in enumerate(mesh.devices)]


def join(blocks: list, n: int, device):
    """The whole tree from its shards' blocks, on ``device``: node-axis
    leaves concatenated in shard order, every other leaf from shard 0."""
    r = len(blocks)
    b = check_rows(n, r)

    def cat(*xs):
        if xs[0] is None:
            return None
        if xs[0].dim() >= 1 and xs[0].shape[0] == b and \
                all(x.shape == xs[0].shape for x in xs):
            return torch.cat([x.to(device) for x in xs])
        return xs[0].to(device, copy=True)

    def walk(*trees):
        if trees[0] is None or isinstance(trees[0], torch.Tensor):
            return cat(*trees)
        return _rebuild(trees[0], (walk(*xs) for xs in zip(*trees)))
    return walk(*blocks)
