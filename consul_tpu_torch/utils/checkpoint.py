"""Checkpoint / resume for simulation state (PyTorch port of
``consul_tpu/utils/checkpoint.py``).

The reference's FORMAT_VERSION 2, byte for byte::

    b"CTPU" | manifest_len (8 LE bytes) | manifest JSON | raw leaf bytes

Leaves are written in NamedTuple field order as contiguous little-endian
buffers. The manifest names each leaf by the path the reference's
``jax.tree_util.keystr`` gives a NamedTuple field (``.swim.viv.vec``),
with numpy's dtype names (``bfloat16``, ``float8_e4m3fn``) and a SHA-256
digest of the payload, checked on restore. bfloat16 and float8 leaves are
written and read through their bytes (``tensor.view(torch.uint8)``), so
nothing here needs numpy to know those dtypes.

The same state saved by either package gives the same file, so a
checkpoint written by one restores in the other, leaf for leaf. A
checkpoint of a state whose dtypes the port does not hold in memory (the
reference's dense ``SimState`` has int32 leaves where the port's has
int64) restores without a template (:func:`restore_tree`) and crosses
over through ``consul_tpu_torch.convert``.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
from typing import Any, BinaryIO

import torch

from consul_tpu_torch.obs import trace as obs_trace

MAGIC = b"CTPU"
FORMAT_VERSION = 2
_MAX_MANIFEST = 64 << 20

# torch dtype -> numpy's name for it (the manifest's dtype strings).
_NAMES = {
    torch.bool: "bool", torch.uint8: "uint8", torch.int8: "int8",
    torch.uint16: "uint16", torch.int16: "int16", torch.uint32: "uint32",
    torch.int32: "int32", torch.uint64: "uint64", torch.int64: "int64",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.float32: "float32", torch.float64: "float64",
    torch.float8_e4m3fn: "float8_e4m3fn",
}
_DTYPES = {v: k for k, v in _NAMES.items()}

if sys.byteorder != "little":
    raise ImportError("checkpoints are little-endian raw buffers")


def flatten(tree: Any, prefix: str = "") -> list:
    """``[(path, tensor)]`` of a (nested) NamedTuple of tensors, in field
    order; paths as keystr renders NamedTuple fields. None is no leaf."""
    out = []
    for name, x in zip(tree._fields, tree):
        path = f"{prefix}.{name}"
        if isinstance(x, torch.Tensor):
            out.append((path, x))
        elif x is not None:
            out.extend(flatten(x, path))
    return out


def unflatten(template: Any, leaves) -> Any:
    """Rebuild ``template``'s structure around ``leaves`` (an iterator of
    tensors, in :func:`flatten` order)."""
    it = iter(leaves)

    def build(t):
        return type(t)(*[next(it) if isinstance(x, torch.Tensor)
                         else (None if x is None else build(x)) for x in t])
    return build(template)


def to_host(tree: Any) -> Any:
    """A copy of a state tree with every leaf on the CPU."""
    return unflatten(tree, [x.detach().cpu() for _, x in flatten(tree)])


def _bytes(x: torch.Tensor) -> bytes:
    return x.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _dtype_name(x: torch.Tensor) -> str:
    try:
        return _NAMES[x.dtype]
    except KeyError:
        raise ValueError(f"no checkpoint dtype for {x.dtype}") from None


@obs_trace.traced("ckpt.save", cat="io")
def save(path: str, state: Any, meta: Any = None) -> str:
    """Write ``state`` (a NamedTuple tree of tensors) to ``path`` and
    return the payload's hex SHA-256. Crash-safe: fsync before the atomic
    rename, so a torn write never replaces a good checkpoint. ``meta``
    (JSON-serializable) rides in the manifest under ``meta``."""
    pairs = flatten(state)
    raw = [_bytes(x) for _, x in pairs]
    h = hashlib.sha256()
    for b in raw:
        h.update(b)
    digest = h.hexdigest()
    manifest = {
        "format_version": FORMAT_VERSION,
        "n_leaves": len(pairs),
        "names": [p for p, _ in pairs],
        "shapes": [list(x.shape) for _, x in pairs],
        "dtypes": [_dtype_name(x) for _, x in pairs],
        "sha256": digest,
        # The reference records each leaf's sharding here; the port's
        # leaves live on one device.
        "partition_spec": [None] * len(pairs),
    }
    if meta is not None:
        manifest["meta"] = meta
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        mjson = json.dumps(manifest).encode()
        f.write(MAGIC)
        f.write(len(mjson).to_bytes(8, "little"))
        f.write(mjson)
        for b in raw:
            f.write(b)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return digest


def _read_header(f: BinaryIO) -> dict:
    """Magic + bounded length-prefixed JSON; a clean ValueError on any
    corruption of the header."""
    magic = f.read(len(MAGIC))
    if magic != MAGIC:
        raise ValueError(f"not a checkpoint (magic {magic!r} != {MAGIC!r})")
    mlen = int.from_bytes(f.read(8), "little")
    if not 0 < mlen <= _MAX_MANIFEST:
        raise ValueError(f"corrupt checkpoint header (manifest length {mlen})")
    try:
        manifest = json.loads(f.read(mlen))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ValueError(f"corrupt checkpoint manifest: {e}") from e
    if manifest.get("format_version") != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {manifest.get('format_version')} "
                         f"!= {FORMAT_VERSION}")
    missing = {"sha256", "names", "n_leaves", "shapes", "dtypes"} - set(manifest)
    if missing:
        raise ValueError(
            f"corrupt checkpoint manifest: missing fields {sorted(missing)}")
    return manifest


def read_manifest(path: str) -> dict:
    with open(path, "rb") as f:
        return _read_header(f)


def read_meta(path: str) -> Any:
    """The ``meta`` the save embedded (or None); reads the header only."""
    return read_manifest(path).get("meta")


def diagnostic_dump_path(dump_dir: str, t: int) -> str:
    """Where the invariant sentinel drops its diagnostic checkpoint of the
    state at tick ``t``."""
    return os.path.join(dump_dir, f"sentinel_diag_t{int(t)}.ckpt")


def state_layout_digest(state: Any, n: int) -> str:
    """Digest of a state's layout: leaf paths, dtypes and shapes with the
    node axis written ``N``. Equal to the reference's digest of the same
    state: two states with one digest restore into each other."""
    parts = []
    for path, x in flatten(state):
        shape = tuple("N" if d == n else int(d) for d in x.shape)
        parts.append(f"{path}:{_dtype_name(x)}:{shape}")
    return hashlib.sha256("|".join(sorted(parts)).encode()).hexdigest()[:16]


def _read_leaves(path: str, verify: bool, check=None):
    """(manifest, [CPU tensors]) of a checkpoint, one leaf at a time,
    hashing as it reads. ``check(manifest)`` runs before the payload."""
    with open(path, "rb") as f:
        manifest = _read_header(f)
        if check is not None:
            check(manifest)
        h = hashlib.sha256()
        out = []
        for shape, dtype in zip(manifest["shapes"], manifest["dtypes"]):
            dt = _DTYPES.get(dtype)
            if dt is None:
                raise ValueError(f"checkpoint leaf dtype {dtype!r} is not "
                                 "one the port reads")
            count = 1
            for d in shape:
                count *= int(d)
            nbytes = count * torch.empty((), dtype=dt).element_size()
            raw = f.read(nbytes)
            if len(raw) != nbytes:
                raise ValueError("checkpoint payload truncated")
            h.update(raw)
            flat = torch.frombuffer(bytearray(raw), dtype=torch.uint8) \
                if nbytes else torch.empty((0,), dtype=torch.uint8)
            out.append(flat.view(dt).reshape(shape))
    if verify and h.hexdigest() != manifest["sha256"]:
        raise ValueError(
            f"checkpoint payload digest mismatch: {h.hexdigest()[:12]}... != "
            f"{manifest['sha256'][:12]}... (corrupt or truncated)")
    return manifest, out


@obs_trace.traced("ckpt.restore", cat="io")
def restore(path: str, template: Any, *, verify: bool = True) -> Any:
    """Load a checkpoint into the structure of ``template`` (a state of
    the same config), each leaf on its template leaf's device. Name,
    shape and dtype mismatches and payload corruption raise before
    anything is returned."""
    t_pairs = flatten(template)

    def check(manifest):
        if len(t_pairs) != manifest["n_leaves"]:
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, template has "
                f"{len(t_pairs)}: config/structure mismatch (saved names: "
                f"{manifest['names'][:4]}...)")
        t_names = [p for p, _ in t_pairs]
        if t_names != manifest["names"]:
            diffs = [f"{saved!r} vs template {now!r}" for saved, now in
                     zip(manifest["names"], t_names) if saved != now]
            raise ValueError("checkpoint field names do not match the "
                             f"template: {diffs[:3]}")
        for (name, x), shape, dtype in zip(t_pairs, manifest["shapes"],
                                           manifest["dtypes"]):
            if tuple(shape) != tuple(x.shape) or dtype != _dtype_name(x):
                raise ValueError(
                    f"leaf {name}: checkpoint {dtype}{list(shape)} vs "
                    f"template {_dtype_name(x)}{list(x.shape)}: was the "
                    "checkpoint written with a different SimConfig?")

    _, leaves = _read_leaves(path, verify, check)
    return unflatten(template, [x.to(t.device) for x, (_, t)
                                in zip(leaves, t_pairs)])


def restore_tree(path: str, *, verify: bool = True) -> dict:
    """Load a checkpoint without a template: nested dicts of CPU tensors
    keyed by the saved field paths, in the saved dtypes (what
    ``consul_tpu_torch.convert`` takes, e.g. the reference's dense state)."""
    manifest, leaves = _read_leaves(path, verify)
    root: dict = {}
    for name, x in zip(manifest["names"], leaves):
        keys = name.lstrip(".").split(".")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = x
    return root


def restore_widened(path: str, dense_template: Any, widen, n: int, *,
                    verify: bool = True) -> tuple:
    """Restore a checkpoint of the dense layout into a packed run:
    ``dense_template`` is the dense twin of the running state
    (``layout.unpack_state``), ``widen`` turns the restored dense state
    into the running layout (``layout.pack_state``). Returns ``(state,
    provenance)`` with both layout digests."""
    state = restore(path, dense_template, verify=verify)
    out = widen(state)
    return out, {"widened_from": state_layout_digest(dense_template, n),
                 "widened_to": state_layout_digest(out, n)}
