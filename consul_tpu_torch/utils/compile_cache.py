"""Where the port's CUDA kernels are built, and what the builds resolved
to (PyTorch port of ``consul_tpu/utils/compile_cache.py``).

The reference points JAX's persistent compilation cache at a directory,
so that a second cold process deserializes its executables instead of
recompiling them. The port's one compiled artifact is the tick kernel's
shared library (``ops/cuda_gossip.build``: ``nvcc`` of
``csrc/gossip_tick.cu``, a file name keyed by a hash of the source), and
its cache is the directory the library is built into:

- :func:`enable` points the build at a directory (created if missing);
  the default is ``build/consul_tpu_torch/`` beside the package;
- :func:`maybe_enable_from_env` wires the ``CONSUL_TPU_COMPILE_CACHE``
  environment variable (the CLI's ``--compile-cache DIR`` calls
  :func:`enable` directly);
- :func:`stats` counts, process-wide, the nvcc builds (misses: each
  records a ``cuda.build`` span) and the libraries found already built
  (hits). A process loads the library once: its later ``build()`` calls
  count nothing, as the reference's in-process executable cache does.

The directory takes effect at the process's first build; once the
library is loaded, a new directory is used by the next process.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

ENV_VAR = "CONSUL_TPU_COMPILE_CACHE"

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_DIR = os.path.join(os.path.dirname(_PKG), "build", "consul_tpu_torch")

_lock = threading.Lock()
_state = {"dir": None, "hits": 0, "misses": 0}


def enable(directory: str) -> str:
    """Build (and look for) the kernels' library under ``directory``,
    created if missing. Returns the absolute path."""
    path = os.path.abspath(directory)
    os.makedirs(path, exist_ok=True)
    with _lock:
        _state["dir"] = path
    return path


def maybe_enable_from_env(environ=os.environ) -> Optional[str]:
    """:func:`enable` the directory of ``CONSUL_TPU_COMPILE_CACHE`` when
    it is set and non-empty; returns it, or None."""
    directory = environ.get(ENV_VAR, "").strip()
    if not directory:
        return None
    return enable(directory)


def build_dir() -> str:
    """The directory the kernels are built into."""
    with _lock:
        return _state["dir"] or DEFAULT_DIR


def record(hit: bool) -> None:
    """Count one library lookup of ``cuda_gossip.build``: found already
    built (a hit) or compiled by nvcc (a miss)."""
    with _lock:
        _state["hits" if hit else "misses"] += 1


def stats() -> dict:
    """``{"enabled", "dir", "hits", "misses"}``, process-wide."""
    with _lock:
        return {"enabled": _state["dir"] is not None,
                "dir": _state["dir"] or DEFAULT_DIR,
                "hits": _state["hits"], "misses": _state["misses"]}


def stats_delta(before: dict) -> dict:
    """The hit and miss movement since a :func:`stats` snapshot."""
    now = stats()
    return {"enabled": now["enabled"], "dir": now["dir"],
            "hits": now["hits"] - before.get("hits", 0),
            "misses": now["misses"] - before.get("misses", 0)}
