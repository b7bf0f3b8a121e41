"""MemoryBudget: pick the chunk, the state layout and the cohort plan for
one device (PyTorch port of ``consul_tpu/runtime/membudget.py``).

The planner answers one question before any tensor is allocated: *how
does a population of n nodes fit this device?* Given the device's memory
(or an explicit budget) and the run's shape (n, kind, chaos, mesh), it
returns a :class:`MemoryPlan` naming

  - the **state layout** (models/layout.py): dense when the working set
    fits comfortably, packed (about 2.5x smaller at rest) when that buys
    the headroom;
  - the **chunk** length of the run loop;
  - the **cohort plan**: ``cohort_n == n`` resident when the population
    fits, otherwise the largest power-of-two divisor of n whose
    double-buffered working set fits the budget: the shape
    ``models.cluster.StreamedSimulation`` streams between host and
    device;
  - the **prewarm signature** (utils/prewarm.py).

Sizing allocates nothing: the states are built on PyTorch's ``meta``
device (shapes and dtypes only, no generator: the draws' values do not
size anything). The numbers are the reference's to the last bit: its
dense SWIM plane holds 4-byte words where the port's working set widens
them to int64 (CPU PyTorch has no uint32 arithmetic), so an int64 leaf of
the dense state counts 4 bytes, and every other leaf has the reference's
dtype. The whole state's bytes, scalars included, are divided by n, as
the reference divides them. The working-set model is the reference's:

    live = buffers * at_rest(layout) + WORKING_MULT * dense_actual
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

import torch

from consul_tpu_torch.config import SimConfig
from consul_tpu_torch.models import layout as layout_mod

KINDS = ("swim", "serf")

# Step-temporary multiplier over the dense per-node working set.
WORKING_MULT = 3.0

# Fraction of the device's budget the plan may fill: headroom for the
# kernels' scratch, the draws, the counters and allocator slack.
FILL_FRACTION = 0.8

_SIZE_RE = re.compile(r"^\s*([0-9]+(?:\.[0-9]+)?)\s*([KMGT]?i?B?)\s*$",
                      re.IGNORECASE)
_UNIT = {"": 1, "B": 1,
         "KB": 10**3, "MB": 10**6, "GB": 10**9, "TB": 10**12,
         "KIB": 2**10, "MIB": 2**20, "GIB": 2**30, "TIB": 2**40}


def parse_budget(budget) -> Optional[int]:
    """"auto" -> None (ask the device); int/float bytes pass through;
    "2GB"/"512MiB"-style strings parse with SI/binary units."""
    if budget is None or budget == "auto":
        return None
    if isinstance(budget, (int, float)):
        return int(budget)
    m = _SIZE_RE.match(str(budget))
    if not m:
        raise ValueError(f"unparseable memory budget {budget!r}")
    num, unit = float(m.group(1)), m.group(2).upper()
    if unit in ("K", "M", "G", "T"):
        unit += "B"
    return int(num * _UNIT[unit])


def device_budget_bytes(device=None) -> int:
    """Bytes of one device: a CUDA device's total memory as the card
    reports it (``torch.cuda.mem_get_info``; ``device=None`` is the
    current card when one is visible), else host RAM (the CPU's tensors
    live there)."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available()
        else torch.device("cpu"))
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError):  # pragma: no cover - exotic platform
        return 8 * 2**30


def _state_abstract(cfg: SimConfig, kind: str, layout: str):
    """One population's at-rest state on the ``meta`` device: shapes and
    dtypes, no storage (safe at any n)."""
    from consul_tpu_torch.models import serf as serf_mod
    from consul_tpu_torch.models import state as sim_state

    init = serf_mod.init if kind == "serf" else sim_state.init
    st = init(cfg, None, "meta")
    return layout_mod.pack_state(st) if layout == layout_mod.PACKED else st


def _leaf_bytes(leaf: torch.Tensor) -> int:
    """A leaf's bytes as the reference holds it (module docstring)."""
    size = 4 if leaf.dtype == torch.int64 else leaf.element_size()
    return int(leaf.numel()) * size


def state_bytes_per_node(cfg: SimConfig, kind: str = "swim",
                         layout: str = layout_mod.DENSE) -> float:
    """At-rest bytes per node for (cfg, kind, layout)."""
    tree = _state_abstract(cfg, kind, layout)
    return sum(_leaf_bytes(x) for x in layout_mod.leaves(tree)) / float(cfg.n)


def dense_f32i32_bytes_per_node(cfg: SimConfig, kind: str = "swim") -> float:
    """The comparison baseline: every dense element at 4 bytes (bools and
    narrow serf lanes counted as if f32/i32)."""
    tree = _state_abstract(cfg, kind, layout_mod.DENSE)
    elems = sum(int(x.numel()) for x in layout_mod.leaves(tree))
    return elems * 4.0 / cfg.n


def live_bytes_per_node(cfg: SimConfig, kind: str, layout: str,
                        buffers: int = 1) -> float:
    """Working-set bytes per node while a population is stepping (the
    module docstring's model)."""
    at_rest = state_bytes_per_node(cfg, kind, layout)
    dense = state_bytes_per_node(cfg, kind, layout_mod.DENSE)
    return buffers * at_rest + WORKING_MULT * dense


@dataclasses.dataclass(frozen=True)
class MemoryPlan:
    """What the planner decided for one run. ``streamed`` means the
    population exceeds the device's budget and goes through
    ``StreamedSimulation`` at ``cohort_n`` nodes a cohort."""

    n: int
    kind: str
    layout: str
    chunk: int
    cohort_n: int
    streamed: bool
    devices: int
    budget_bytes: int
    state_bytes_per_node: float
    dense_bytes_per_node: float       # dense at-rest bytes per node
    dense_f32i32_bytes_per_node: float  # the all-4-byte baseline
    resident_bytes: int               # projected peak per device
    max_n_resident: int               # biggest resident population

    @property
    def packed_cut(self) -> float:
        """Compaction factor against the dense f32/i32 baseline."""
        return self.dense_f32i32_bytes_per_node / self.state_bytes_per_node

    def prewarm_args(self) -> dict:
        """The signature utils/prewarm.prewarm warms: one shape covers
        every cohort (and the resident case, whose one "cohort" is the
        whole population)."""
        return {
            "ns": [self.cohort_n],
            "kinds": [self.kind],
            "chunks": [self.chunk],
            "layout": self.layout,
        }

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["packed_cut"] = round(self.packed_cut, 3)
        return d


def _pow2_cohort(n: int, max_cohort: int) -> int:
    """Largest n / 2**k (no smaller than 1,024) that fits ``max_cohort``
    nodes."""
    cohort = n
    while cohort > max_cohort and cohort % 2 == 0 and cohort > 1024:
        cohort //= 2
    return cohort


def plan(cfg: SimConfig, kind: str = "swim", layout: str = "auto",
         budget="auto", chaos: bool = False, mesh=None,
         chunk: Optional[int] = None, device=None) -> MemoryPlan:
    """Pick (layout, chunk, cohort plan) for running ``cfg`` on this device
    or mesh under ``budget`` bytes per device (``"auto"``: the device's
    own, :func:`device_budget_bytes`).

    ``layout="auto"`` keeps the dense layout whenever the whole population
    fits it resident, and switches to packed only when compaction is what
    makes the run fit (or shrinks the cohort count of a streamed run).
    ``chaos`` reserves schedule headroom; ``mesh`` divides the population
    over its devices."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}; got {kind!r}")
    devices = 1
    if mesh is not None:
        devices = int(getattr(mesh, "size", None) or len(mesh.devices))
    total = parse_budget(budget)
    if total is None:
        total = device_budget_bytes(device)
    usable = int(total * FILL_FRACTION)
    if chaos:
        # Schedule masks are [N, slots] bytes: budget a slim slice.
        usable = int(usable * 0.95)

    n_dev = cfg.n // devices  # nodes this device must hold

    def max_resident(lay: str) -> int:
        return int(usable / live_bytes_per_node(cfg, kind, lay, buffers=1))

    if layout == "auto":
        layout = (layout_mod.DENSE if n_dev <= max_resident(layout_mod.DENSE)
                  else layout_mod.PACKED)
    layout_mod.validate(cfg, layout)

    fits = n_dev <= max_resident(layout)
    if fits:
        cohort_n, streamed, buffers = cfg.n, False, 1
    else:
        if devices > 1:
            raise ValueError(
                "beyond-budget populations stream on a single device; "
                "shrink n per device or raise the budget")
        # Streaming double-buffers: two cohorts resident at the swap.
        per_cohort = int(usable
                         / live_bytes_per_node(cfg, kind, layout, buffers=2))
        cohort_n = _pow2_cohort(cfg.n, per_cohort)
        streamed, buffers = True, 2
        if not cfg.view_degree:
            raise ValueError(
                f"streaming needs the sparse view (view_degree > 0), but "
                f"this config is dense (view_degree=0, topology family "
                f"{cfg.topo_family!r}): a dense view is O(n^2) state and "
                f"cannot stream in cohorts; pass --view-degree (an even "
                f"K, e.g. 16) and optionally --family to pick the view "
                f"graph (consul_tpu_torch/topo/families.py)")

    if chunk is None:
        # Huge populations take smaller chunks, so a chunk's wall time
        # stays interactive.
        chunk = 64 if (cohort_n if streamed else n_dev) <= 2**21 else 16

    per_node = state_bytes_per_node(cfg, kind, layout)
    resident = int(live_bytes_per_node(cfg, kind, layout, buffers)
                   * (cohort_n if streamed else n_dev))
    return MemoryPlan(
        n=cfg.n,
        kind=kind,
        layout=layout,
        chunk=chunk,
        cohort_n=cohort_n,
        streamed=streamed,
        devices=devices,
        budget_bytes=usable,
        state_bytes_per_node=per_node,
        dense_bytes_per_node=state_bytes_per_node(cfg, kind,
                                                  layout_mod.DENSE),
        dense_f32i32_bytes_per_node=dense_f32i32_bytes_per_node(cfg, kind),
        resident_bytes=resident,
        max_n_resident=max_resident(layout),
    )
