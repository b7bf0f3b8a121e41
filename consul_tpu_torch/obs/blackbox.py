"""The CUDA-init black box (PyTorch port of ``consul_tpu/obs/blackbox.py``):
capture *why* a child wedged while bringing up the card.

A CUDA context that never comes up leaves no traceback: the child is
blocked inside the NVIDIA driver (a device query, the first allocation) when
the supervisor (``runtime/watchdog.InitWatchdog``) kills it, so the only
evidence is what the host can still see. This module is the flight
recorder's dump for that moment:

- the environment that steers the card's bring-up (``CUDA_*``,
  ``NCCL_*``, ``TORCH_*``, ``PYTORCH_*``, ``NVIDIA_*``);
- the installed torch and its CUDA version, the kernel driver's version
  line (``/proc/driver/nvidia/version``) and the ``nvcc`` the CUDA
  library would be built with (``cuda_info``, the reference's
  ``libtpu_info``);
- the tail of the child's last output (the supervisor passes it);
- how far bring-up got in THIS process: whether torch is imported and
  CUDA initialized, and the devices only when CUDA already is
  (``device_progress``): a device query on a wedged driver is the call
  that hangs;
- the last host spans from the process tracer's bounded ring
  (``obs/trace.py``).

:func:`capture` writes one ``blackbox.json`` (the reference's keys, with
``cuda`` in ``libtpu``'s place) and returns the dict.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional

SCHEMA_VERSION = 1

# Environment prefixes that steer the card's bring-up.
_ENV_PREFIXES = ("CUDA", "NCCL", "TORCH", "PYTORCH", "NVIDIA")

# The kernel driver's version file.
DRIVER_VERSION_FILE = "/proc/driver/nvidia/version"

# Default log-tail / span-tail sizes: enough to see the last moves,
# bounded so the file stays a few KB.
_TAIL_LINES = 50
_LAST_SPANS = 64


def capture_env() -> dict:
    """The bring-up environment (sorted, values verbatim: these are
    configuration knobs, not secrets)."""
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith(_ENV_PREFIXES)}


def tail_file(path: str, lines: int = _TAIL_LINES) -> Optional[str]:
    """Last ``lines`` lines of a text file; None when unreadable."""
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - 64 * 1024))
            data = f.read().decode("utf-8", errors="replace")
    except OSError:
        return None
    return "\n".join(data.splitlines()[-lines:])


def cuda_info() -> dict:
    """torch's version and its CUDA version, the kernel driver's version
    line and the nvcc path the CUDA library's build would use. Reads only:
    it initializes no CUDA context."""
    info: dict = {"torch": None, "cuda": None, "driver": None, "nvcc": None}
    try:
        import torch

        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
    except ImportError as e:
        info["torch_error"] = repr(e)
    try:
        with open(DRIVER_VERSION_FILE) as f:
            info["driver"] = f.readline().strip()
    except OSError as e:
        info["version_error"] = repr(e)
    try:
        from consul_tpu_torch.ops import cuda_gossip

        info["nvcc"] = cuda_gossip._nvcc()
    except RuntimeError as e:
        info["nvcc_error"] = str(e)
    return info


def device_progress() -> dict:
    """How far the card's bring-up got in THIS process, read without a
    device query unless CUDA is already initialized (a query on a wedged
    driver is the call that hangs). ``cuda_initialized`` false during an
    init hang means the wedge is inside the first bring-up."""
    out: dict = {"torch_imported": False, "cuda_initialized": False,
                 "devices": [], "error": None}
    if "torch" not in sys.modules:
        return out  # never pay for (or hang in) an import here
    out["torch_imported"] = True
    try:
        import torch

        out["cuda_initialized"] = bool(torch.cuda.is_initialized())
        if out["cuda_initialized"]:
            out["devices"] = [torch.cuda.get_device_name(i)
                              for i in range(torch.cuda.device_count())]
    except Exception as e:  # noqa: BLE001 - diagnosis must never raise
        out["error"] = repr(e)
    return out


def capture(path: Optional[str] = None, *,
            status: Optional[str] = None,
            child_tail: Optional[str] = None,
            extra: Optional[dict] = None,
            last_spans: int = _LAST_SPANS) -> dict:
    """Assemble the black box; write it to ``path`` (blackbox.json) when
    given. Every section is best-effort: a postmortem that raises is worse
    than a partial one."""
    from consul_tpu_torch.obs import trace as trace_mod

    box: dict = {
        "schema_version": SCHEMA_VERSION,
        "status": status,
        "env": capture_env(),
        "cuda": cuda_info(),
        "devices": device_progress(),
        "child": {"tail": child_tail},
        "spans": trace_mod.get_tracer().last_spans(last_spans),
    }
    if extra:
        box.update(extra)
    if path:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(box, f, indent=2, default=str)
    return box
