"""Serving-side cache operations (the sharded programs wait, ROADMAP
Queue 1), the sweep service's host-side process helpers, and federated
LLM training on one process (``aggregation``, ``fed_trainer``)."""
from repro_torch.distributed.sharding import (host_assignment,
                                              init_distributed,
                                              process_count, process_index,
                                              row_block)

__all__ = ["host_assignment", "init_distributed", "process_count",
           "process_index", "row_block"]
