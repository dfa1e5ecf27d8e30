"""Sharding of the port: the reference's partition rules
(:mod:`.specs`) and a train state split over a (data, model) mesh with
explicit collectives (:mod:`.state`)."""

from .specs import (DATA, axis_sizes, batch_specs, cache_specs, fit_spec,
                    local_shape, opt_specs, param_specs)

__all__ = ["DATA", "axis_sizes", "batch_specs", "cache_specs", "fit_spec",
           "local_shape", "opt_specs", "param_specs"]
