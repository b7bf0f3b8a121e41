"""Debug bundle (PyTorch port of ``consul_tpu/utils/debug.py``): the
``consul debug`` capture of a running simulation.

The reference CLI bundles metrics, host info, agent self-description,
profiles and logs into a tarball (command/debug/debug.go: captureStatic
:299, captureDynamic :353). The port's counterparts:

- :func:`capture_sim`: host info, the simulation's config, health and
  telemetry, the host-span ring and the node lens when armed, and, with
  ``profile_ticks`` > 0, a ``torch.profiler`` trace of that many ticks
  (CUDA activity on a CUDA simulation), the pprof profile's counterpart,
  written as a Chrome trace under ``trace_dir``;
- :func:`write_bundle` packs everything into one ``.tar.gz``.

The reference's ``capture_static`` (the same set fetched over the HTTP
API) comes with the port's host tier (ROADMAP A21).
"""

from __future__ import annotations

import collections
import dataclasses
import io
import json
import os
import platform
import tarfile
import time
from typing import Optional

import torch

# The profile's file name under ``trace_dir``.
TRACE_FILE = "trace.json"


def _host_info() -> dict:
    """agent/debug/host.go:20-31's counterpart. Devices are listed only
    when CUDA is ALREADY initialized: a capture must never bring up the
    card itself (a device query on a wedged driver hangs)."""
    info = {
        "Hostname": platform.node(),
        "OS": platform.system(),
        "Platform": platform.platform(),
        "Python": platform.python_version(),
        "CollectionTime": int(time.time() * 1e9),
        "Torch": torch.__version__,
        "Cuda": torch.version.cuda,
    }
    try:
        if torch.cuda.is_initialized():
            info["Devices"] = [torch.cuda.get_device_name(i)
                               for i in range(torch.cuda.device_count())]
        else:
            info["Devices"] = "not initialized (host-side capture)"
    except Exception as e:  # noqa: BLE001 - host info must never fail
        info["TorchError"] = repr(e)
    return info


def capture_sim(sim, profile_ticks: int = 0,
                trace_dir: Optional[str] = None) -> dict[str, dict]:
    """Capture a running simulation: config, health, telemetry, the span
    ring and the lens; and, when ``profile_ticks`` > 0, a
    ``torch.profiler`` trace of that many ticks (metrics off) written to
    ``trace_dir/trace.json``, with the kernels it recorded counted by name
    in ``profile.json``. A CUDA simulation's profile that holds no CUDA
    kernel raises: an empty profile is no profile."""
    from torch.profiler import ProfilerActivity, profile

    from consul_tpu_torch.obs import trace as obs_trace
    from consul_tpu_torch.utils import metrics as m

    out: dict[str, dict] = {"host.json": _host_info()}
    out["config.json"] = dataclasses.asdict(sim.cfg)
    h = m.health(sim.cfg, sim.topo, sim.swim_state)
    out["health.json"] = {
        "agreement": float(h.agreement),
        "false_positive": float(h.false_positive),
        "undetected": float(h.undetected),
        "live_nodes": int(h.live_nodes),
        "vivaldi_rmse_ms": float(sim.rmse()) * 1000.0,
        "tick": int(sim._t),
    }
    out["metrics.json"] = sim.sink.snapshot()
    # The flight recorder's view of this process: the host-span ring and,
    # when the node lens is armed, its recorded timelines.
    out["spans.json"] = obs_trace.get_tracer().to_json()
    if sim.lens is not None:
        out["lens.json"] = sim.lens.to_json()
    if profile_ticks > 0 and trace_dir:
        cuda = sim.device.type == "cuda"
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            sim.run(profile_ticks, with_metrics=False)
            if cuda:
                torch.cuda.synchronize(sim.device)
        os.makedirs(trace_dir, exist_ok=True)
        path = os.path.join(trace_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        # Kernels only: the trace's "kernel" category leaves out the device
        # side of user annotations (sim_chunk), memcpys and memsets.
        with open(path) as f:
            kernels = collections.Counter(
                e.get("name", "") for e in json.load(f)["traceEvents"]
                if e.get("cat") == "kernel")
        if cuda and not kernels:
            raise RuntimeError("the profile of a CUDA simulation recorded no "
                               "CUDA kernel (is CUPTI tracing available?)")
        out["profile.json"] = {"trace_dir": trace_dir, "trace": path,
                               "ticks": profile_ticks,
                               "kernels": dict(kernels)}
    return out


def write_bundle(path: str, files: dict[str, dict],
                 extra_dirs: Optional[list[str]] = None) -> str:
    """Pack captures (and optional trace directories) into a .tar.gz, the
    debug.go tarball (:553-)."""
    with tarfile.open(path, "w:gz") as tar:
        for name, payload in files.items():
            blob = json.dumps(payload, indent=2, default=str).encode()
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            info.mtime = int(time.time())
            tar.addfile(info, io.BytesIO(blob))
        for d in extra_dirs or []:
            if os.path.isdir(d):
                tar.add(d, arcname=os.path.basename(d.rstrip("/")))
    return path
