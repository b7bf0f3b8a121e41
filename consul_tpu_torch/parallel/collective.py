"""Row-axis primitives of the step, on one device or sharded over a mesh
(PyTorch port of ``consul_tpu/parallel/collective.py``).

Every cross-node exchange of the SWIM plane is a circulant roll along the
node axis; the serf plane adds a read of arbitrary global rows
(:func:`all_rows`, :func:`take_rows`) and a delivery to them
(:func:`sum_scatter_rows`). Outside a shard context every primitive is the
single-device expression: a shift known on the host is a ``torch.roll``,
a shift held in a device tensor (a per-tick draw) an index gather, so the
step never reads the device to learn it.

**Sharded.** The reference runs its step under ``shard_map`` with the
context :func:`node_axis` installs (its ``NodeAxisCtx``). The port keeps
that single-controller model with one thread per shard
(parallel/shard_step.py): each thread runs the step on its row block of
``n / R`` rows inside :func:`node_axis`, and the primitives exchange
through a :class:`ShardBoard` in the process: every shard posts its
tensor, waits at a barrier, copies what it needs from the others' posts,
and waits again. Every barrier has a timeout, and a shard that fails
breaks the barrier for all of them, so a fault ends the run instead of
hanging it. Shards may share a device; each exchange copies all the
same, as it would between cards.

- :func:`roll` with a host-known shift moves at most two block slices
  (the reference's ``_roll_static``); with a shift in a tensor it
  gathers the rows and indexes them locally, never reading the shift on
  the host.
- :func:`tree_psum` sums in shard order, and :func:`sum_scatter_rows`
  sums each shard's full-height scatter the same way and keeps the
  block: integer sums, exact.

**Draws: global, then sliced.** The controller draws one tick's bundle
for the whole cluster from the simulation's one generator and each shard
takes its rows (``mesh.block_of``), so a sharded run is bit-equal to one
device with no per-row key streams.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import NamedTuple, Optional

import torch

# Seconds a shard waits at a barrier before the run fails.
BARRIER_TIMEOUT_S = 120.0


class ShardAborted(RuntimeError):
    """A barrier broke: another shard failed or a wait timed out."""


class ShardBoard:
    """The in-process exchange of ``n_shards`` shard threads: post,
    barrier, read, barrier. The second barrier keeps a shard from posting
    its next tensor before every shard has read this one."""

    def __init__(self, n_shards: int):
        self.n_shards = n_shards
        self._slots = [None] * n_shards
        self._barrier = threading.Barrier(n_shards, timeout=BARRIER_TIMEOUT_S)

    def abort(self):
        """Break the barrier for every shard (one of them failed)."""
        self._barrier.abort()

    def _wait(self):
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError:
            raise ShardAborted("a shard failed or a barrier timed out") from None

    def exchange(self, shard: int, x):
        """Post ``x`` (a tensor, a tree of them or None) and return every
        shard's post, in shard order. The work behind a CUDA tensor is
        finished before the post is visible."""
        for dev in _cuda_devices(x):
            torch.cuda.synchronize(dev)
        self._slots[shard] = x
        self._wait()
        posts = list(self._slots)
        self._wait()
        return posts


def _cuda_devices(x) -> set:
    if isinstance(x, torch.Tensor):
        return {x.device} if x.is_cuda else set()
    if isinstance(x, (tuple, list)):
        return set().union(*(_cuda_devices(y) for y in x)) if x else set()
    return set()


class NodeAxisCtx(NamedTuple):
    n_shards: int      # shards along the node axis
    n_global: int      # global node count (block = n_global // n_shards)
    shard: int         # this program's shard
    board: Optional[ShardBoard]


_CTX: contextvars.ContextVar[Optional[NodeAxisCtx]] = contextvars.ContextVar(
    "consul_tpu_torch_node_axis", default=None)


def current() -> Optional[NodeAxisCtx]:
    return _CTX.get()


def sharded() -> bool:
    return _CTX.get() is not None


@contextlib.contextmanager
def node_axis(n_shards: int, n_global: int, shard: int,
              board: Optional[ShardBoard] = None):
    """Declare that per-node tensors inside this context are shard
    ``shard``'s block of ``n_global // n_shards`` rows. Without a
    ``board`` only row-local work runs (an exchange raises)."""
    if n_global % n_shards != 0:
        raise ValueError(f"n_global={n_global} not divisible by {n_shards}")
    if not 0 <= shard < n_shards:
        raise ValueError(f"shard {shard} outside [0, {n_shards})")
    tok = _CTX.set(NodeAxisCtx(n_shards, n_global, shard, board))
    try:
        yield
    finally:
        _CTX.reset(tok)


def _posts(ctx: NodeAxisCtx, x):
    if ctx.board is None:
        raise RuntimeError("a cross-shard exchange needs the shard board "
                           "(parallel/shard_step.py runs the step with one)")
    return ctx.board.exchange(ctx.shard, x)


def _copy(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return x.to(like.device, copy=True)


def local_n(n: int) -> int:
    """Local row count for a global node count ``n``."""
    ctx = _CTX.get()
    return n if ctx is None else n // ctx.n_shards


def rows(n: int, device="cpu") -> torch.Tensor:
    """Global row ids of the rows this program holds."""
    ctx = _CTX.get()
    if ctx is None:
        return torch.arange(n, dtype=torch.int64, device=device)
    b = n // ctx.n_shards
    return ctx.shard * b + torch.arange(b, dtype=torch.int64, device=device)


def roll(x: torch.Tensor, shift) -> torch.Tensor:
    """Circular roll along the node axis: ``out[g] = x[(g - shift) mod N]``
    in global row coordinates."""
    ctx = _CTX.get()
    if ctx is None:
        if isinstance(shift, torch.Tensor):
            n = x.shape[0]
            idx = (rows(n, x.device) - shift) % n
            return x[idx]
        return torch.roll(x, int(shift), 0)
    n = ctx.n_global
    if isinstance(shift, torch.Tensor):
        return all_rows(x)[(rows(n, x.device) - shift) % n]
    return _roll_static(ctx, x, int(shift) % n)


def _roll_static(ctx: NodeAxisCtx, x: torch.Tensor, s: int) -> torch.Tensor:
    """The block's rows come from rows [(base - s) mod N, ... + B): the tail
    of one source block and the head of the next, two transfers at most."""
    if s == 0:
        return x
    b = ctx.n_global // ctx.n_shards
    posts = _posts(ctx, x)
    src, o = divmod((ctx.shard * b - s) % ctx.n_global, b)
    parts = [_copy(posts[src][o:], x)]
    if o:
        parts.append(_copy(posts[(src + 1) % ctx.n_shards][:o], x))
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def roll_many(arrays, shift):
    """Roll several same-row-count tensors by one shared shift (sharded:
    one exchange for all of them)."""
    ctx = _CTX.get()
    if ctx is None or not isinstance(shift, torch.Tensor):
        return [roll(a, shift) for a in arrays]
    idx = (rows(ctx.n_global, arrays[0].device) - shift) % ctx.n_global
    return [x[idx] for x in all_rows_many(arrays)]


def rolls(x: torch.Tensor, shifts) -> list:
    """``x`` rolled by each of several shifts, host-known or in tensors
    (sharded: one exchange, then a local gather per shift)."""
    ctx = _CTX.get()
    if ctx is None:
        return [roll(x, s) for s in shifts]
    n = ctx.n_global
    full, r = all_rows(x), rows(n, x.device)
    return [full[(r - s) % n] for s in shifts]


def all_rows(x: torch.Tensor) -> torch.Tensor:
    """The full per-row array, for gathers by arbitrary global row id (a
    query's origin). Identity on one device."""
    return all_rows_many([x])[0]


def all_rows_many(arrays) -> list:
    """:func:`all_rows` of several tensors in one exchange."""
    ctx = _CTX.get()
    if ctx is None:
        return list(arrays)
    posts = _posts(ctx, list(arrays))
    return [torch.cat([_copy(p[i], x) for p in posts])
            for i, x in enumerate(arrays)]


def take_rows(x: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """``x`` indexed by global row ids."""
    return all_rows(x)[gidx]


def take_rows_many(arrays, gidx: torch.Tensor) -> list:
    """:func:`take_rows` of several tensors at one index, one exchange."""
    return [x[gidx] for x in all_rows_many(arrays)]


def tree_psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the shards, in shard order (exact for integers); the
    identity on one device."""
    ctx = _CTX.get()
    if ctx is None:
        return x
    posts = _posts(ctx, x)
    acc = _copy(posts[0], x)
    for p in posts[1:]:
        acc = acc + _copy(p, x)
    return acc


def any_rows(x: torch.Tensor) -> torch.Tensor:
    """``any`` over the global node axis."""
    local = torch.any(x)
    if _CTX.get() is None:
        return local
    return tree_psum(local.to(torch.int32)) > 0


def sum_scatter_rows(idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter-add ``vals`` at global row ids ``idx`` and return each row's
    total: every row on one device, this shard's block when sharded (the
    full-height scatters summed in shard order, then sliced). ``vals`` may
    carry trailing axes. Integer adds, so the result is exact."""
    full = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                       device=vals.device).index_add_(0, idx, vals)
    ctx = _CTX.get()
    if ctx is None:
        return full
    b = n // ctx.n_shards
    return tree_psum(full)[ctx.shard * b:(ctx.shard + 1) * b]


def shard_once(x: torch.Tensor) -> torch.Tensor:
    """Zero a replicated global value on every shard but 0, so that the
    counters' sum over shards counts it once; the identity on one
    device."""
    ctx = _CTX.get()
    if ctx is None or ctx.shard == 0:
        return x
    return torch.zeros_like(x)
