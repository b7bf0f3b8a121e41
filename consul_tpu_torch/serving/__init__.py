"""Query-serving plane (PyTorch port of ``consul_tpu/serving``).

Batched NearestN / health / catalog / distance reads straight from the
simulation's tensors: a :class:`QueryBatcher` packs concurrent requests
into fixed-shape bucketed batches, each batch runs as one masked top-k
call (``ops/serving.py``) against a double-buffered snapshot
(:class:`ServingPlane`), and results fan back out to waiters. The host
``server/rtt.py`` is the reference the batched path is held to.

The write-side twin (``ServingPlane.attach_writes``): a
:class:`WriteBatcher` coalesces catalog/KV/session writes into
fixed-shape batches applied between flips (``ops/deltas.py``, monotone
raft-style apply index), and a :class:`WatchPlane` serves blocking
queries and watches as deltas between consecutive snapshot flips. Both
batchers run bounded queues with reject/shed admission control;
``ServingPlane.close()`` wakes every parked waiter with
:class:`ServingClosedError`. :class:`AsyncFrontend`
(``serving/frontend.py``) puts one event loop on one owned thread in front
of both batchers, with an HTTP listener for the wire surface.
"""

from consul_tpu_torch.ops.serving import (MODE_CATALOG, MODE_DIST,
                                          MODE_HEALTH, MODE_NEAREST,
                                          MODE_NOOP, Snapshot)
from consul_tpu_torch.serving.batcher import (QueryBatcher, QueryResult,
                                              ServingClosedError,
                                              ServingOverloadError)
from consul_tpu_torch.serving.frontend import AsyncFrontend
from consul_tpu_torch.serving.plane import NearestResult, ServingPlane
from consul_tpu_torch.serving.watch import Watcher, WatchEvent, WatchPlane
from consul_tpu_torch.serving.writes import (KeyTable, WriteBatcher,
                                             WriteResult)

__all__ = [
    "AsyncFrontend", "MODE_CATALOG", "MODE_DIST", "MODE_HEALTH",
    "MODE_NEAREST", "MODE_NOOP", "KeyTable", "NearestResult", "QueryBatcher", "QueryResult",
    "ServingClosedError", "ServingOverloadError", "ServingPlane",
    "Snapshot", "Watcher", "WatchEvent", "WatchPlane", "WriteBatcher",
    "WriteResult",
]
