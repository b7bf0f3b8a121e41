"""Host span tracing (PyTorch port of ``consul_tpu/obs/trace.py``): the
flight recorder for the host seams around the card.

The card's side already has a profiler (``torch.profiler``, CUPTI);
what it cannot see is the *host* choreography around the launches: the
chunk loop, batcher pumps, watch-plane flips, checkpoint I/O, DCN
rounds, the raft commit pump and the nvcc build. This module is a
stdlib-only tracer for those seams, a copy of the reference's:

- one shared :class:`Tracer` per process (module-level singleton behind
  :func:`get_tracer`), always recording into a bounded ring buffer, so
  the last spans are there for the init black box even when nobody
  asked for a trace;
- spans via context manager (:func:`span`) or decorator
  (:func:`traced`), timed with ``time.perf_counter`` (monotonic);
- export as Chrome trace-event JSON (:meth:`Tracer.export`), which
  Perfetto and ``chrome://tracing`` load; the node lens appends its
  per-node counter tracks to the same file;
- the kernel build folded in: ``ops/cuda_gossip.build`` records each
  real nvcc compile as a ``cat="cuda"`` ``cuda.build`` span here (a
  cached load records nothing);
- span durations flow into an attached telemetry Sink as
  ``sim.obs.span.<name>`` samples.

Alignment with the device profile: the chunk loop wraps each chunk in
:func:`chunk_annotation`, which opens a ``torch.profiler``
``record_function("sim_chunk")`` range and, on a CUDA simulation, an
NVTX range ``sim_chunk#<step>``, around a host ``chunk`` span with the
same step number, so a profiler trace and this file line up by step.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from collections import deque
from typing import Callable, Optional

# The golden schema (tests/test_torch_obs.py holds it to the reference's).
SCHEMA_VERSION = 1

# Ring capacity: bounded so an un-exported tracer never grows the
# process. 4096 events at ~200 B each is under a megabyte.
DEFAULT_CAPACITY = 4096

# Metric-name prefix for span-duration samples.
SPAN_METRIC_PREFIX = "sim.obs.span"

PRODUCER = "consul-tpu-torch obs.trace"


class Tracer:
    """Bounded ring of Chrome trace events, monotonic-clocked.

    Timestamps are microseconds since the tracer's birth on the
    ``perf_counter`` clock: durations are exact, absolute wall time is
    deliberately absent (spans measure, they do not timestamp)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._t0 = time.perf_counter()
        self._pid = os.getpid()
        self._sink = None
        self.dropped = 0  # events evicted by the bounded ring

    # -- clock ----------------------------------------------------------
    def now_us(self) -> float:
        """Microseconds since tracer birth (monotonic)."""
        return (time.perf_counter() - self._t0) * 1e6

    # -- sink mirror ----------------------------------------------------
    def attach_sink(self, sink) -> None:
        """Mirror span durations into a telemetry Sink as
        ``sim.obs.span.<name>`` samples. Last attach wins: one process,
        one sink, like the Sink itself."""
        self._sink = sink

    # -- recording ------------------------------------------------------
    def _append(self, ev: dict) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def complete(self, name: str, start_us: float, dur_us: float,
                 cat: str = "host", args: Optional[dict] = None,
                 tid: Optional[int] = None) -> None:
        """Record one complete ("X") span with explicit timing (the nvcc
        build's entry point, which learns the duration after the fact)."""
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": round(start_us, 3), "dur": round(dur_us, 3),
              "pid": self._pid,
              "tid": tid if tid is not None else threading.get_ident()}
        if args:
            ev["args"] = dict(args)
        self._append(ev)
        sink = self._sink
        if sink is not None:
            sink.add_sample(f"{SPAN_METRIC_PREFIX}.{name}", dur_us / 1e3)

    def instant(self, name: str, cat: str = "host",
                args: Optional[dict] = None) -> None:
        """Record an instant ("i") event: a point marker, no duration
        (and no sink sample)."""
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": round(self.now_us(), 3), "pid": self._pid,
              "tid": threading.get_ident()}
        if args:
            ev["args"] = dict(args)
        self._append(ev)

    def counter(self, name: str, value: float, ts_us: float,
                series: str = "value", pid: Optional[int] = None) -> None:
        """Record a counter ("C") sample: a point on a counter track."""
        self._append({"name": name, "cat": "lens", "ph": "C",
                      "ts": round(ts_us, 3),
                      "pid": pid if pid is not None else self._pid,
                      "args": {series: float(value)}})

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "host",
             args: Optional[dict] = None):
        """Time a block as one complete span."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            t1 = time.perf_counter()
            self.complete(name, (t0 - self._t0) * 1e6, (t1 - t0) * 1e6,
                          cat=cat, args=args)

    def traced(self, name: Optional[str] = None, cat: str = "host"
               ) -> Callable:
        """Decorator form of :meth:`span`."""
        def deco(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*a, **kw):
                with self.span(label, cat=cat):
                    return fn(*a, **kw)
            return wrapper
        return deco

    # -- reads ----------------------------------------------------------
    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def last_spans(self, n: int = 64) -> list:
        """The newest ``n`` events: the black box's flight-recorder
        tail."""
        with self._lock:
            evs = list(self._events)
        return evs[-n:]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    # -- export ---------------------------------------------------------
    def to_json(self, extra_events: Optional[list] = None) -> dict:
        """The Chrome trace-event JSON object: ``traceEvents`` plus
        provenance in ``otherData``."""
        evs = self.events()
        if extra_events:
            evs = evs + list(extra_events)
        return {
            "traceEvents": evs,
            "displayTimeUnit": "ms",
            "otherData": {
                "schema_version": SCHEMA_VERSION,
                "producer": PRODUCER,
                "clock": "perf_counter_us_since_tracer_birth",
                "dropped_events": self.dropped,
            },
        }

    def export(self, path: str,
               extra_events: Optional[list] = None) -> str:
        """Write the Perfetto-loadable JSON file; returns ``path``.
        ``extra_events`` (the lens's counter tracks) merge into it."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(extra_events), f)
        return path


# -- the shared process tracer ------------------------------------------
_TRACER: Optional[Tracer] = None
_TRACER_LOCK = threading.Lock()


def get_tracer() -> Tracer:
    """The one process-wide tracer. Always recording (bounded ring), so
    the black box has a span tail even when nobody exports."""
    global _TRACER
    with _TRACER_LOCK:
        if _TRACER is None:
            _TRACER = Tracer()
        return _TRACER


@contextlib.contextmanager
def span(name: str, cat: str = "host", args: Optional[dict] = None):
    """Module-level sugar: a span on the shared tracer."""
    with get_tracer().span(name, cat=cat, args=args):
        yield


def traced(name: Optional[str] = None, cat: str = "host") -> Callable:
    """Module-level decorator sugar on the shared tracer (bound at call
    time, so tests that reset the tracer see their spans)."""
    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with get_tracer().span(label, cat=cat):
                return fn(*a, **kw)
        return wrapper
    return deco


@contextlib.contextmanager
def chunk_annotation(step_num: int, ticks: int, device=None):
    """Bracket one chunk: a ``torch.profiler`` ``record_function(
    "sim_chunk")`` range (in the profiler's trace), on a CUDA ``device``
    an NVTX range ``sim_chunk#<step_num>`` too, and a host ``chunk``
    span with the same step number, the alignment key between the
    timelines. A CPU simulation has no NVTX to annotate, so it opens
    none (the CPU build of torch raises on the NVTX calls)."""
    import torch

    nvtx = device is not None and torch.device(device).type == "cuda"
    with torch.profiler.record_function("sim_chunk"):
        if nvtx:
            torch.cuda.nvtx.range_push(f"sim_chunk#{int(step_num)}")
        try:
            with span("chunk", cat="chunk",
                      args={"step": int(step_num), "ticks": int(ticks)}):
                yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
