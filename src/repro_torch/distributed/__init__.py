"""Serving-side cache operations (the sharded programs, ``make_serve_fns``,
wait: ROADMAP Queue 1), the sweep service's host-side process helpers,
and federated LLM training (``aggregation``, ``fed_trainer``): on one
process, and the flat trainer with D split over a mesh's "model" ranks.
The tree trainer under a mesh waits."""
from repro_torch.distributed.sharding import (host_assignment,
                                              init_distributed,
                                              mesh_axis_size,
                                              process_count, process_index,
                                              row_block)

__all__ = ["host_assignment", "init_distributed", "mesh_axis_size",
           "process_count", "process_index", "row_block"]
