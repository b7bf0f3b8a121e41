"""View-graph family registry (numpy; a copy of the reference's)."""

from consul_tpu_torch.topo.families import (  # noqa: F401
    FAMILIES,
    offsets_for,
    register,
    spectral_gap,
    validate_offsets,
)
