"""Distributed serving for the port: logical-axis sharding rules over a
``(data, model)`` mesh of torch.distributed ranks (``sharding.py``)."""
from repro_torch.distributed.sharding import (
    DEFAULT_RULES,
    active_mesh,
    axis_rules,
    param_specs,
    place_params,
)

__all__ = ["DEFAULT_RULES", "active_mesh", "axis_rules", "param_specs",
           "place_params"]
