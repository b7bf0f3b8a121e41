"""Row-axis primitives of the step, single device (PyTorch port of the
unsharded half of ``consul_tpu/parallel/collective.py``).

Every cross-node exchange of the SWIM plane is a circulant roll along the
node axis. A shift known on the host is a ``torch.roll``; a shift held
in a device tensor (a per-tick draw) becomes an index gather, so the step
never reads the device to learn it. The per-row random draws of the
reference become the explicit ``TickDraws`` bundle (models/swim.py), and
the sharded forms come with the multi-GPU slice.
"""

from __future__ import annotations

import torch


def rows(n: int, device="cpu") -> torch.Tensor:
    """Row ids of the rows this program holds (all of them)."""
    return torch.arange(n, dtype=torch.int64, device=device)


def roll(x: torch.Tensor, shift) -> torch.Tensor:
    """Circular roll along axis 0: ``out[g] = x[(g - shift) mod N]``."""
    if isinstance(shift, torch.Tensor):
        n = x.shape[0]
        idx = (rows(n, x.device) - shift) % n
        return x[idx]
    return torch.roll(x, int(shift), 0)


def roll_many(arrays, shift):
    """Roll several same-row-count tensors by one shared shift."""
    return [roll(a, shift) for a in arrays]


def take_rows(x: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """``x`` indexed by global row ids."""
    return x[gidx]


def any_rows(x: torch.Tensor) -> torch.Tensor:
    """``any`` over the node axis."""
    return torch.any(x)


def all_rows(x: torch.Tensor) -> torch.Tensor:
    """The full per-row array, for gathers by arbitrary row id (a query's
    origin). Identity on one device."""
    return x


def sum_scatter_rows(idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """Scatter-add ``vals`` at row ids ``idx`` and return each row's total
    (the query-response tallies). ``vals`` may carry trailing axes. Integer
    adds, so the result is exact in any order."""
    full = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                       device=vals.device)
    return full.index_add_(0, idx, vals)
