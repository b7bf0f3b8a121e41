"""Async serving front end: one event loop in front of the batchers
(PyTorch port of ``consul_tpu/serving/frontend.py``).

The threaded serving tier parks every in-flight request on its own
``threading.Event`` (QueryBatcher / WriteBatcher ``submit``, WatchPlane
``wait_index``): one Python thread per parked waiter. An
:class:`AsyncFrontend` runs a single asyncio event loop on ONE owned thread
and multiplexes many logically blocking requests as futures: reads and
writes coalesce on the loop into the same padded bucketed batches the
threaded path builds (``QueryBatcher.execute`` / ``WriteBatcher.execute``,
so both paths share one device call and one result contract,
``ops/serving`` and ``ops/deltas``), and blocking-query waiters park as
loop timers woken by the WatchPlane's index listeners instead of
condition-variable threads. Each flush runs inside a
``frontend.read_flush`` / ``frontend.write_flush`` span of the process
tracer.

An optional asyncio HTTP listener (:meth:`AsyncFrontend.serve_http`)
serves the wire surface over the same loop: ``/v1/kv``,
``/v1/catalog/nodes``, ``/v1/catalog/register``, ``/v1/health/service``
and ``/v1/agent/self``, with ``?index=`` + ``?wait=`` blocking queries
answered with ``X-Consul-Index`` under ``agent/http.parse_blocking``, so a
multi-process client swarm (``gameday/swarm.py``) can drive it over
sockets. Narrowings, as the reference's: KV values are the plane's one
i32 word per key, nodes and services are the simulation's integer labels,
and a PUT acknowledged under raft reports ``proposed`` until the commit
pump lands it.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import json
import threading
from typing import Optional
from urllib.parse import parse_qs, urlparse

from consul_tpu_torch.obs import trace as obs_trace
from consul_tpu_torch.serving.batcher import (ServingClosedError,
                                        ServingOverloadError)

_MAX_BODY = 1 << 20


class AsyncFrontend:
    """One event loop multiplexing reads/writes/blocking queries in
    front of a write-attached :class:`ServingPlane`.

    Every ``submit_*`` call is thread-safe and returns a
    ``concurrent.futures.Future`` immediately; a caller that wants the
    threaded-path blocking shape just calls ``.result()``. The point
    is that N in-flight requests cost N future objects and ONE loop
    thread — not N parked threads."""

    def __init__(self, plane, max_wait_s: Optional[float] = None,
                 max_batch: Optional[int] = None):
        self.plane = plane
        self.max_wait_s = (float(max_wait_s) if max_wait_s is not None
                           else plane.batcher.max_wait_s)
        self.max_batch = (int(max_batch) if max_batch is not None
                          else plane.batcher.max_batch)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()
        self._closed = False
        # Pending request queues — touched ONLY from the loop thread.
        self._reads: list = []        # (mode, src, arg, future)
        self._writes: list = []       # (op, target, arg, future)
        self._read_timer = None
        self._write_timer = None
        # Index waiters: {future: (min_index, timer)} — loop thread only.
        self._index_waiters: dict = {}
        self._listening = False
        self._server = None
        # Counters (mirrored into the plane's sink).
        self.reads = 0
        self.writes = 0
        self.batches = 0
        self.http_requests = 0
        self.inflight_peak = 0

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def start(self) -> "AsyncFrontend":
        if self._thread is not None:
            return self
        self._loop = asyncio.new_event_loop()
        # The front end's ONE owned thread, tracked on self and joined in
        # close().
        self._thread = threading.Thread(
            target=self._run_loop, name="serving-frontend", daemon=True)
        self._thread.start()
        self._started.wait(5.0)
        watch = getattr(self.plane, "watch", None)
        if watch is not None:
            watch.add_index_listener(self._on_index)
        return self

    def _run_loop(self) -> None:
        asyncio.set_event_loop(self._loop)
        self._loop.call_soon(self._started.set)
        self._loop.run_forever()

    def close(self) -> None:
        """Idempotent: unhook the index listener, fail every pending
        future with ServingClosedError, stop the loop, join the one
        owned thread."""
        if self._closed:
            return
        self._closed = True
        watch = getattr(self.plane, "watch", None)
        if watch is not None:
            watch.remove_index_listener(self._on_index)
        loop = self._loop
        if loop is None:
            return
        done = threading.Event()

        def _shutdown():
            err = ServingClosedError("async frontend closed")
            for *_x, fut in self._reads + self._writes:
                if not fut.done():
                    fut.set_exception(err)
            self._reads, self._writes = [], []
            for fut, (_mi, timer) in list(self._index_waiters.items()):
                timer.cancel()
                if not fut.done():
                    fut.set_exception(err)
            self._index_waiters.clear()
            if self._server is not None:
                self._server.close()
            # Retire live connection coroutines before stopping the
            # loop — a pending task destroyed with the loop warns at
            # GC time and can leak its socket.
            tasks = list(asyncio.all_tasks(loop))
            for t in tasks:
                t.cancel()

            async def _finish():
                await asyncio.gather(*tasks, return_exceptions=True)
                loop.stop()
                done.set()

            loop.create_task(_finish())

        loop.call_soon_threadsafe(_shutdown)
        done.wait(5.0)
        if self._thread is not None:
            self._thread.join(5.0)

    @property
    def closed(self) -> bool:
        return self._closed

    def owned_threads(self) -> int:
        """Live threads this frontend owns (the parity test's bound)."""
        return 1 if self._thread is not None and self._thread.is_alive() \
            else 0

    # ------------------------------------------------------------------
    # Submission (thread-safe; futures resolve on the loop)
    # ------------------------------------------------------------------
    def _ensure_open(self):
        if self._closed or self._thread is None:
            raise ServingClosedError(
                "async frontend is not running (call start())")

    def submit_read(self, mode: int, src: int, arg: int = -1
                    ) -> concurrent.futures.Future:
        """Enqueue one read; the future resolves to a QueryResult.
        Reads coalesce for up to ``max_wait_s`` (or until a max batch
        fills) and run as ONE bucketed kernel via
        ``QueryBatcher.execute`` — the same executable the threaded
        pump uses."""
        self._ensure_open()
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._loop.call_soon_threadsafe(
            self._enqueue_read, (int(mode), int(src), int(arg), fut))
        return fut

    def submit_write(self, op: int, target: int, arg: int = -1
                     ) -> concurrent.futures.Future:
        """Enqueue one write; the future resolves to a WriteResult.
        Admission control mirrors the WriteBatcher contract (same
        ``max_pending`` bound, same policy, same sink counters) except
        that a rejection surfaces ON the future rather than at the
        submit call — the caller is not parked, so there is no
        synchronous raise point."""
        self._ensure_open()
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._loop.call_soon_threadsafe(
            self._enqueue_write, (int(op), int(target), int(arg), fut))
        return fut

    def wait_index(self, min_index: int = 0, wait_s: float = 10.0
                   ) -> concurrent.futures.Future:
        """The blocking-query primitive as a future: resolves to the
        apply index once it exceeds ``min_index`` (immediately when it
        already does), or at the wait deadline — same floor contract
        as ``WatchPlane.wait_index`` (never below ``min_index``, never
        below 1), with the waiter parked as a loop timer instead of a
        thread."""
        self._ensure_open()
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._loop.call_soon_threadsafe(
            self._enqueue_index_wait, int(min_index), float(wait_s), fut)
        return fut

    # -- convenience verbs (sim addressing, mirror ServingPlane's) ------
    def kv_put(self, key: str, value: int) -> concurrent.futures.Future:
        from consul_tpu_torch.ops import deltas as deltas_mod

        slot = self.plane.keys.slot_for(key, create=True)
        if slot < 0:
            fut: concurrent.futures.Future = concurrent.futures.Future()
            fut.set_exception(ServingOverloadError(
                f"kv slot table full ({self.plane.keys.slots} slots)"))
            return fut
        return self.submit_write(deltas_mod.OP_KV_PUT, slot, int(value))

    def register(self, node: int, service: int) -> concurrent.futures.Future:
        from consul_tpu_torch.ops import deltas as deltas_mod

        return self.submit_write(deltas_mod.OP_REGISTER, node, service)

    def nearest(self, src: int, service: int = -1
                ) -> concurrent.futures.Future:
        from consul_tpu_torch.ops import serving as kernels

        return self.submit_read(kernels.MODE_NEAREST, src, service)

    def catalog_nodes(self, service: int = -1) -> concurrent.futures.Future:
        from consul_tpu_torch.ops import serving as kernels

        return self.submit_read(kernels.MODE_CATALOG, 0, service)

    def health_nodes(self, service: int = -1) -> concurrent.futures.Future:
        from consul_tpu_torch.ops import serving as kernels

        return self.submit_read(kernels.MODE_HEALTH, 0, service)

    # ------------------------------------------------------------------
    # Loop-side machinery
    # ------------------------------------------------------------------
    def _note_inflight(self):
        inflight = (len(self._reads) + len(self._writes)
                    + len(self._index_waiters))
        if inflight > self.inflight_peak:
            self.inflight_peak = inflight

    def _enqueue_read(self, item) -> None:
        self._reads.append(item)
        self._note_inflight()
        if len(self._reads) >= self.max_batch:
            self._flush_reads()
        elif self._read_timer is None:
            self._read_timer = self._loop.call_later(
                self.max_wait_s, self._flush_reads)

    def _enqueue_write(self, item) -> None:
        wb = self.plane.writes
        if wb is None:
            item[3].set_exception(RuntimeError(
                "plane has no write path (attach_writes first)"))
            return
        if len(self._writes) >= wb.max_pending:
            sink = getattr(self.plane, "sink", None)
            if wb.policy == "reject":
                wb.rejected += 1
                if sink is not None:
                    sink.incr_counter("sim.serving.rejected", 1)
                item[3].set_exception(ServingOverloadError(
                    f"write queue full ({wb.max_pending} pending, "
                    "policy=reject)"))
                return
            from consul_tpu_torch.serving.writes import WriteResult

            shed = self._writes.pop(0)
            wb.shed += 1
            if sink is not None:
                sink.incr_counter("sim.serving.shed", 1)
            if not shed[3].done():
                shed[3].set_result(
                    WriteResult(applied=False, index=0, status="shed"))
        self._writes.append(item)
        self._note_inflight()
        if len(self._writes) >= wb.max_batch:
            self._flush_writes()
        elif self._write_timer is None:
            self._write_timer = self._loop.call_later(
                self.max_wait_s, self._flush_writes)

    def _flush_reads(self) -> None:
        if self._read_timer is not None:
            self._read_timer.cancel()
            self._read_timer = None
        batch, self._reads = self._reads, []
        if not batch:
            return
        self.batches += 1
        self.reads += len(batch)
        sink = getattr(self.plane, "sink", None)
        if sink is not None:
            sink.incr_counter("sim.serving.frontend_reads", len(batch))
            sink.incr_counter("sim.serving.frontend_batches", 1)
        with obs_trace.span("frontend.read_flush", cat="serving",
                            args={"n": len(batch)}):
            try:
                results = self.plane.batcher.execute(
                    [(m, s, a) for m, s, a, _f in batch])
            except Exception as e:  # noqa: BLE001 — fan the error out
                for *_x, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                return
        for (*_x, fut), res in zip(batch, results):
            if not fut.done():
                fut.set_result(res)

    def _flush_writes(self) -> None:
        if self._write_timer is not None:
            self._write_timer.cancel()
            self._write_timer = None
        batch, self._writes = self._writes, []
        if not batch:
            return
        self.batches += 1
        self.writes += len(batch)
        sink = getattr(self.plane, "sink", None)
        if sink is not None:
            sink.incr_counter("sim.serving.frontend_writes", len(batch))
            sink.incr_counter("sim.serving.frontend_batches", 1)
        with obs_trace.span("frontend.write_flush", cat="serving",
                            args={"n": len(batch)}):
            try:
                results = self.plane.writes.execute(
                    [(o, t, a) for o, t, a, _f in batch])
            except Exception as e:  # noqa: BLE001
                for *_x, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                return
        for (*_x, fut), res in zip(batch, results):
            if not fut.done():
                fut.set_result(res)

    def _enqueue_index_wait(self, min_index: int, wait_s: float,
                            fut) -> None:
        watch = self.plane.watch
        cur = watch.apply_index if watch is not None else 0
        if watch is None or cur > min_index:
            fut.set_result(max(cur, min_index, 1))
            return

        def _expire():
            self._index_waiters.pop(fut, None)
            if not fut.done():
                fut.set_result(max(watch.apply_index, min_index, 1))

        timer = self._loop.call_later(max(0.0, wait_s), _expire)
        self._index_waiters[fut] = (min_index, timer)
        self._note_inflight()

    def _on_index(self, index: int) -> None:
        """WatchPlane index-listener: hop onto the loop and wake every
        waiter the new index (or a plane close) releases."""
        loop = self._loop
        if loop is None or self._closed:
            return
        try:
            loop.call_soon_threadsafe(self._wake_index_waiters, index)
        except RuntimeError:
            pass  # loop already stopped under close()

    def _wake_index_waiters(self, index: int) -> None:
        watch = self.plane.watch
        closed = watch is None or watch._closed
        for fut, (min_index, timer) in list(self._index_waiters.items()):
            if closed or index > min_index:
                timer.cancel()
                del self._index_waiters[fut]
                if not fut.done():
                    fut.set_result(max(index, min_index, 1))

    # ------------------------------------------------------------------
    # HTTP listener (the swarm-facing wire surface)
    # ------------------------------------------------------------------
    def serve_http(self, host: str = "127.0.0.1", port: int = 0
                   ) -> tuple[str, int]:
        """Start an asyncio HTTP/1.1 listener on the frontend's loop;
        returns the bound (host, port). Requests multiplex on the SAME
        event loop as every future above — a thousand parked blocking
        queries are a thousand coroutines, zero extra threads."""
        self._ensure_open()
        fut: concurrent.futures.Future = concurrent.futures.Future()

        async def _start():
            server = await asyncio.start_server(
                self._serve_conn, host=host, port=port)
            self._server = server
            fut.set_result(server.sockets[0].getsockname()[:2])

        asyncio.run_coroutine_threadsafe(_start(), self._loop)
        got = fut.result(10.0)
        self._listening = True
        return got[0], got[1]

    async def _serve_conn(self, reader, writer) -> None:
        try:
            while True:
                line = await reader.readline()
                if not line:
                    return
                try:
                    method, target, _proto = line.decode().split()
                except ValueError:
                    return
                clen = 0
                keep = True
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    name, _, val = h.decode().partition(":")
                    if name.strip().lower() == "content-length":
                        clen = min(int(val.strip()), _MAX_BODY)
                    if name.strip().lower() == "connection" and \
                            val.strip().lower() == "close":
                        keep = False
                body = await reader.readexactly(clen) if clen else b""
                status, payload, hdrs = await self._route(
                    method.upper(), target, body)
                data = json.dumps(payload).encode()
                head = [f"HTTP/1.1 {status} X",
                        "Content-Type: application/json",
                        f"Content-Length: {len(data)}"]
                head += [f"{k}: {v}" for k, v in hdrs.items()]
                head.append("Connection: keep-alive" if keep
                            else "Connection: close")
                writer.write(("\r\n".join(head) + "\r\n\r\n").encode()
                             + data)
                await writer.drain()
                if not keep:
                    return
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            try:
                writer.close()
            except OSError:
                pass

    async def _route(self, method: str, target: str, body: bytes
                     ) -> tuple[int, object, dict]:
        from consul_tpu_torch.agent.http import parse_blocking

        self.http_requests += 1
        sink = getattr(self.plane, "sink", None)
        if sink is not None:
            sink.incr_counter("sim.serving.frontend_http", 1)
        u = urlparse(target)
        q = {k: v[-1] for k, v in parse_qs(u.query,
                                           keep_blank_values=True).items()}
        parts = [p for p in u.path.split("/") if p]
        try:
            min_index, wait_s = parse_blocking(q)
        except ValueError:
            return 400, {"error": "bad index/wait"}, {}
        try:
            return await self._dispatch(method, parts, q, body,
                                        min_index, wait_s)
        except (ServingClosedError, ServingOverloadError) as e:
            return 503, {"error": str(e)}, {}
        except (ValueError, KeyError) as e:
            return 400, {"error": str(e)}, {}
        except Exception as e:  # noqa: BLE001 — never drop the conn
            return 500, {"error": f"internal: {e!r}"}, {}

    async def _dispatch(self, method, parts, q, body, min_index, wait_s):
        if parts[:2] == ["v1", "agent"] and parts[2:] == ["self"]:
            return 200, {"Config": {"NodeName": "serving-frontend"},
                         "Stats": {"apply_index":
                                   self.plane.apply_index}}, {}
        if "index" in q:
            # The blockingQuery contract: park (as a loop timer) until
            # the flip index passes the caller's, then serve the read.
            idx = await asyncio.wrap_future(
                self.wait_index(min_index, wait_s))
        else:
            idx = max(self.plane.apply_index, 1)
        hdrs = {"X-Consul-Index": str(idx)}
        if parts[:2] == ["v1", "kv"] and len(parts) >= 3:
            key = "/".join(parts[2:])
            if method == "GET":
                row = self.plane.kv_get(key)
                if row is None:
                    return 404, None, hdrs
                return 200, [row], {"X-Consul-Index":
                                    str(max(row["ModifyIndex"], idx))}
            if method == "PUT":
                val = int(body or b"0")
                res = await asyncio.wrap_future(self.kv_put(key, val))
                ok = bool(res.applied) or res.status == "proposed"
                if res.index > 0:
                    hdrs["X-Consul-Index"] = str(res.index)
                return 200, ok, hdrs
        if parts[:3] == ["v1", "catalog", "nodes"] and method == "GET":
            res = await asyncio.wrap_future(
                self.catalog_nodes(int(q.get("service", -1))))
            return 200, self._rows(res), hdrs
        if parts[:3] == ["v1", "catalog", "register"] and method == "PUT":
            doc = json.loads(body or b"{}")
            res = await asyncio.wrap_future(self.register(
                int(doc.get("Node", 0)), int(doc.get("Service", 0))))
            if res.index > 0:
                hdrs["X-Consul-Index"] = str(res.index)
            return 200, bool(res.applied) or res.status == "proposed", hdrs
        if parts[:3] == ["v1", "health", "service"] and len(parts) == 4 \
                and method == "GET":
            service = int(parts[3])
            if "near" in q:
                res = await asyncio.wrap_future(
                    self.nearest(int(q["near"]), service))
            else:
                res = await asyncio.wrap_future(self.health_nodes(service))
            return 200, self._rows(res), hdrs
        return 404, {"error": f"no route {method} /{'/'.join(parts)}"}, {}

    @staticmethod
    def _rows(res) -> list:
        return [{"Node": int(res.ids[j]), "RTT": float(res.rtts[j])}
                for j in range(min(res.count, len(res.ids)))
                if int(res.ids[j]) >= 0]

    # ------------------------------------------------------------------
    # Stats
    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {
            "frontend_reads": self.reads,
            "frontend_writes": self.writes,
            "frontend_batches": self.batches,
            "frontend_http": self.http_requests,
            "frontend_inflight_peak": self.inflight_peak,
            "frontend_threads": self.owned_threads(),
        }
