"""Flight-recorder observability plane (PyTorch port of ``consul_tpu/obs``).

Three layers, one file format:

- :mod:`consul_tpu_torch.obs.trace`: host span tracing, a stdlib-only
  tracer (context manager and decorator, monotonic clock, bounded
  process-wide ring) writing Chrome trace-event / Perfetto JSON, with the
  nvcc build folded in and each chunk bracketed by a ``torch.profiler``
  range and, on the card, an NVTX range;
- :mod:`consul_tpu_torch.obs.lens`: the node lens, S sampled node ids
  recorded every tick into a device buffer (launch L on the card),
  exported as per-node counter tracks in the same file;
- :mod:`consul_tpu_torch.obs.blackbox`: the CUDA-init black box, what a
  supervisor can still see when a child wedges bringing up the card.
"""

from consul_tpu_torch.obs import blackbox, lens, trace  # noqa: F401

__all__ = ["blackbox", "lens", "trace"]
