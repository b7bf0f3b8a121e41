"""Run-time guard rails for the port's device path (PyTorch port of
``consul_tpu/analysis/guards.py``).

- :class:`CompileLedger`: a process-wide count of the kernels' nvcc
  builds, one per ``cuda.build`` span that ``ops/cuda_gossip.build``
  records (``utils/compile_cache``'s misses). Tests pin steady state
  with ``ledger.expect(0)`` around a repeated call pattern: a build
  inside the window fails with the observed count. (The reference counts
  XLA's backend compiles; the port compiles nothing else.)
- :func:`no_transfers`: ``torch.cuda.set_sync_debug_mode("error")``
  scoped as a context manager. Inside it any operation that
  synchronizes the host with the card (a ``.item()``, a device-to-host
  copy, a ``nonzero``) raises, which is the discipline of the chunk
  loop: every host read is written down at the chunk boundary. The mode
  in force before is put back on exit.

The host-sync rules of the port live here, in ``consul_tpu_torch``;
the reference's static lint (``consul_tpu/analysis``) checks the
reference only.
"""

from __future__ import annotations

import contextlib

import torch

from consul_tpu_torch.utils import compile_cache


class CompileLedgerError(AssertionError):
    """An ``expect()`` window saw a different number of builds."""


class CompileLedger:
    """A handle on the process-wide build count::

        led = CompileLedger()
        sim.run(64)              # builds the library once, if needed
        with led.expect(0):      # steady state: no build
            sim.run(64)
    """

    @property
    def total(self) -> int:
        """nvcc builds of the kernels in this process so far."""
        return compile_cache.stats()["misses"]

    def delta(self, since: int) -> int:
        return self.total - since

    @contextlib.contextmanager
    def expect(self, n: int, what: str = ""):
        """Assert exactly ``n`` builds happen inside the block."""
        start = self.total
        yield self
        got = self.delta(start)
        if got != n:
            label = f" ({what})" if what else ""
            raise CompileLedgerError(
                f"expected exactly {n} kernel build(s){label}, observed "
                f"{got} inside the pinned window")


@contextlib.contextmanager
def no_transfers():
    """Forbid host synchronizations with the card inside the block
    (``torch.cuda.set_sync_debug_mode("error")``); the previous mode is
    restored after. Build and warm outside the block first. Without a
    CUDA device there is nothing to guard and the block runs as is."""
    if not torch.cuda.is_available():
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)
