"""Meshes of torch devices over the node axis (PyTorch port of
``consul_tpu/parallel/mesh.py``).

The reference shards the node axis of one simulated cluster over a
``jax.sharding.Mesh`` that one process drives (single-controller). The
port keeps that model: a :class:`Mesh` is an ordered list of torch
devices on one node axis (or a (dc, nodes) grid, flattened row-major),
and shard ``d`` owns the global rows ``[d * n / R, (d + 1) * n / R)`` on
``devices[d]``. A device may repeat, so several shards can share one card
(``["cuda:0"] * 4``) or the CPU (``["cpu"] * 4``).

Shards that sit on one device form a group (:func:`device_groups`: a
maximal run of consecutive shards on one device). A group keeps one
storage per leaf and hands its shards adjacent row views of it
(:func:`split`, :func:`adjoin`), so shard ``d``'s rows sit right after
shard ``d - 1``'s and the group reads as one block (:func:`group_view`).
A leaf named in ``full`` is stored full height per group: the group's
rows in their place among all ``n``, the other rows left for an exchange
to fill (the sharded CUDA tick's mirrors). Only groups exchange rows;
shards of one group read each other's in place. NCCL and multi-process
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


def federation_rows(mesh: Mesh, n_dc: int, nodes_per_dc: int) -> tuple:
    """The mesh row of each of ``n_dc`` datacenters over a 2-D (dc, nodes)
    mesh of D rows of R devices (the reference's ``federation_sharding``,
    parallel/mesh.py:174-197): row ``r`` holds the DCs ``[r * n_dc / D,
    (r + 1) * n_dc / D)``, each one node-sharded over the row's R devices
    (:func:`row_mesh`). Raises where the mesh has no dc axis, D does not
    divide ``n_dc`` or R does not divide ``nodes_per_dc``."""
    if DC_AXIS not in mesh.axis_names or len(mesh.shape) != 2:
        raise ValueError(f"a federation is placed over a 2-D ({DC_AXIS}, "
                         f"{NODE_AXIS}) mesh (make_mesh(devices, n_dc=D)); "
                         f"this mesh's axes are {mesh.axis_names}")
    rows, _ = mesh.shape
    if n_dc % rows != 0:
        raise ValueError(f"n_dc={n_dc} must divide over the mesh's {rows} "
                         f"{DC_AXIS} rows")
    check_rows(nodes_per_dc, mesh.shape[1])
    per = n_dc // rows
    return tuple(dc // per for dc in range(n_dc))


def row_mesh(mesh: Mesh, r: int) -> Mesh:
    """Row ``r`` of a 2-D (dc, nodes) mesh as a 1-D node mesh."""
    width = mesh.shape[1]
    return Mesh(mesh.devices[r * width:(r + 1) * width])


def is_row_leaf(leaf, n: int) -> bool:
    """The one node-axis rule: a leaf whose leading dim is the node count
    splits by row block; every other leaf replicates."""
    return isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 and \
        leaf.shape[0] == n


def device_groups(mesh: Mesh) -> tuple:
    """The mesh's shards grouped by device: each group a maximal run of
    consecutive shards on one device, in mesh order. ``["cuda:0"] * 4`` is
    one group; one card per shard is one group per shard."""
    groups, run = [], [0]
    for d in range(1, mesh.size):
        if mesh.devices[d] == mesh.devices[d - 1]:
            run.append(d)
        else:
            groups.append(tuple(run))
            run = [d]
    groups.append(tuple(run))
    return tuple(groups)


def shard_groups(mesh: Mesh) -> tuple:
    """One group per shard, wherever the shards sit: the grouping of a
    mesh of one card per shard, which one card can run to check it."""
    return tuple((d,) for d in range(mesh.size))


def check_groups(mesh: Mesh, groups=None) -> tuple:
    """``groups`` (default :func:`device_groups`) as a tuple of tuples,
    held to the mesh: consecutive runs of shards that cover it in order,
    each run on one device."""
    if groups is None:
        return device_groups(mesh)
    groups = tuple(tuple(int(d) for d in g) for g in groups)
    flat = [d for g in groups for d in g]
    if flat != list(range(mesh.size)) or not all(groups):
        raise ValueError(f"groups {groups} are not consecutive runs covering "
                         f"the {mesh.size} shards in order")
    for g in groups:
        if any(mesh.devices[d] != mesh.devices[g[0]] for d in g):
            raise ValueError(f"group {g} spans more than one device")
    return groups


def _rebuild(tree, items):
    """A tuple, list or NamedTuple like ``tree`` holding ``items``."""
    items = list(items)
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def _flatten(tree, path=""):
    """(path, leaf) pairs of a tree, in order; paths join NamedTuple field
    names (or list indices) with dots."""
    if tree is None or isinstance(tree, torch.Tensor):
        return [(path, tree)]
    names = getattr(tree, "_fields", None) or [str(i) for i in range(len(tree))]
    return [pl for f, x in zip(names, tree)
            for pl in _flatten(x, f"{path}.{f}" if path else f)]


def _unflatten(tree, leaves):
    """A tree shaped like ``tree`` holding ``leaves`` (an iterator)."""
    if tree is None or isinstance(tree, torch.Tensor):
        return next(leaves)
    return _rebuild(tree, (_unflatten(x, leaves) for x in tree))


def _group_storage(xs, group, b: int, n: int, device, full: bool):
    """One group's storage of a row leaf from its shards' rows ``xs`` (in
    group order) and the shards' views of it: the group's rows, or with
    ``full`` all ``n`` rows with the group's in their place (the rest
    left for an exchange to fill)."""
    x0 = xs[0]
    base = 0 if full else group[0] * b
    store = torch.empty((n if full else len(group) * b,) + tuple(x0.shape[1:]),
                        dtype=x0.dtype, device=device)
    views = []
    for d, x in zip(group, xs):
        v = store[d * b - base:(d + 1) * b - base]
        v.copy_(x)
        views.append(v)
    return views


def _place(mesh: Mesh, n: int, groups, full, trees, is_row):
    """Blocks of ``trees`` (one per shard, or the one whole tree for every
    shard) as adjacent views of one storage per group per row leaf."""
    groups = check_groups(mesh, groups)
    b = check_rows(n, mesh.size)
    flat = [_flatten(t) for t in trees]
    out = [None] * mesh.size
    for g in groups:
        dev = mesh.devices[g[0]]
        cols = []
        for k, (path, _) in enumerate(flat[0]):
            xs = [flat[d if len(flat) > 1 else 0][k][1] for d in g]
            if xs[0] is None:
                cols.append([None] * len(g))
            elif is_row(path, xs[0]):
                if len(flat) == 1:
                    xs = [xs[0][d * b:(d + 1) * b] for d in g]
                cols.append(_group_storage(xs, g, b, n, dev, path in full))
            else:
                cols.append([x.to(dev, copy=True) for x in xs])
        for i, d in enumerate(g):
            out[d] = _unflatten(trees[0], iter([c[i] for c in cols]))
    return out


def split(mesh: Mesh, tree, n: int, groups=None, full=frozenset(),
          rows=None) -> list:
    """Place a whole tree on the mesh: each shard's block holds its rows
    of every node-axis leaf (``rows``, a set of leaf paths, or by default
    every leaf whose leading dim is ``n``) as adjacent views of one
    storage per group (:func:`device_groups` unless ``groups`` is given),
    full height for the paths in ``full``; every other leaf a copy of its
    own. Always copies ``tree``."""
    if rows is None:
        return _place(mesh, n, groups, full, [tree],
                      lambda _p, x: is_row_leaf(x, n))
    return _place(mesh, n, groups, full, [tree],
                  lambda p, x: p in rows and is_row_leaf(x, n))


def adjoin(blocks: list, mesh: Mesh, n: int, groups=None,
           full=frozenset()) -> list:
    """Per-shard blocks (say, each edited on its own) copied into adjacent
    views of one storage per group, as :func:`split` places a whole
    tree: a leaf whose leading dim is the shard's row count is a row
    leaf, every other leaf is copied per shard."""
    b = check_rows(n, mesh.size)
    if len(blocks) != mesh.size:
        raise ValueError(f"{len(blocks)} blocks for a mesh of {mesh.size} shards")
    return _place(mesh, n, groups, full, list(blocks),
                  lambda _p, x: x.dim() >= 1 and x.shape[0] == b)


def block_of(tree, n: int, shard: int, n_shards: int, device):
    """Shard ``shard``'s copy of ``tree`` on ``device``: its rows of every
    node-axis leaf, every other leaf whole. Always a copy."""
    b = check_rows(n, n_shards)

    def take(path, x):
        if x is None:
            return None
        if is_row_leaf(x, n):
            return _group_storage([x[shard * b:(shard + 1) * b]], (shard,),
                                  b, n, device, False)[0]
        return x.to(device, copy=True)
    return _unflatten(tree, iter([take(p, x) for p, x in _flatten(tree)]))


def _adjacency_error(what: str) -> ValueError:
    return ValueError(f"{what}: a group's blocks must be adjacent row views "
                      "of one storage; place them with parallel.mesh.split "
                      "(a whole tree) or parallel.mesh.adjoin (per-shard "
                      "blocks)")


def group_view(xs, group, b: int, n: int, full: bool = False,
               what: str = "leaf") -> torch.Tensor:
    """The one storage behind a group's blocks of a leaf (``xs``, the
    group's shards' views in order), without a copy: the group's rows, or
    with ``full`` all ``n`` rows (:func:`full_view`). Raises, naming
    :func:`split` and :func:`adjoin`, where the blocks are not adjacent
    views of one storage."""
    x0 = xs[0]
    if x0.dim() < 1 or x0.shape[0] != b or not x0.is_contiguous():
        raise _adjacency_error(what)
    ptr = x0.untyped_storage().data_ptr()
    for prev, x in zip(xs, xs[1:]):
        if (x.shape != x0.shape or x.dtype != x0.dtype or not x.is_contiguous()
                or x.untyped_storage().data_ptr() != ptr
                or x.storage_offset() != prev.storage_offset() + b * prev.stride(0)):
            raise _adjacency_error(what)
    view = x0.as_strided((len(xs) * b,) + tuple(x0.shape[1:]), x0.stride(),
                         x0.storage_offset())
    return full_view(view, group[0] * b, n, what) if full else view


def full_view(x: torch.Tensor, row0: int, n: int,
              what: str = "leaf") -> torch.Tensor:
    """All ``n`` rows of the full-height storage of which ``x`` holds the
    rows [row0, row0 + len(x)) (what :func:`split` makes for a path in
    its ``full``), without a copy; raises where the storage is not one."""
    stride = x.stride()
    offset = x.storage_offset() - row0 * stride[0]
    end = (offset + n * stride[0]) * x.element_size()
    if not x.is_contiguous() or offset < 0 or (
            x.numel() and end > x.untyped_storage().nbytes()):
        raise _adjacency_error(what + " (full height)")
    return x.as_strided((n,) + tuple(x.shape[1:]), stride, offset)


def group_tree(blocks: list, group, b: int, n: int, rows=None):
    """One group's blocks as one tree without a copy: each row leaf its
    :func:`group_view` (``rows``, a set of leaf paths, or by default every
    leaf whose leading dim is ``b``), every other leaf the group's first
    block's."""
    flat = [_flatten(blocks[d]) for d in group]
    out = []
    for k, (path, x0) in enumerate(flat[0]):
        row = x0 is not None and x0.dim() >= 1 and x0.shape[0] == b and (
            rows is None or path in rows)
        out.append(group_view([f[k][1] for f in flat], group, b, n,
                              what=path) if row else x0)
    return _unflatten(blocks[group[0]], iter(out))


def shard_views(tree, group, b: int) -> list:
    """A group's tree (row leaves of the group's ``len(group) * b`` rows)
    as its shards' blocks: row views, every other leaf shared."""
    rows = len(group) * b
    flat = _flatten(tree)
    return [_unflatten(tree, iter([
        x[i * b:(i + 1) * b] if x is not None and x.dim() >= 1
        and x.shape[0] == rows else x for _, x in flat]))
        for i in range(len(group))]


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
