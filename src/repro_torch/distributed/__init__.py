"""Distributed layers of the port: the leaf placement rules of the
("pod", "data", "model") mesh and the sweep service's process helpers
(``sharding``), federated LLM training (``aggregation``, ``fed_trainer``:
on one process, the flat trainer with D split over a mesh's "model"
ranks, and the tree trainer under a mesh), and serving (``serving``:
the mesh-sharded prefill and decode of ``make_serve_fns`` and the
continuous-batching engine's cache operations). The DTensor carriers
they run on are :mod:`repro_torch.carriers`'."""
from repro_torch.distributed import aggregation, sharding
from repro_torch.distributed.fed_trainer import (FedConfig, FedState,
                                                 common_sample_coin,
                                                 fed_state_shardings,
                                                 fed_train_step,
                                                 init_fed_state,
                                                 make_fed_step)
from repro_torch.distributed.sharding import (host_assignment, host_group,
                                              init_distributed,
                                              leave_distributed,
                                              mesh_axis_size,
                                              process_count, process_index,
                                              row_block)

__all__ = ["FedConfig", "FedState", "aggregation", "common_sample_coin",
           "fed_state_shardings", "fed_train_step", "host_assignment",
           "host_group",
           "init_distributed", "init_fed_state", "leave_distributed",
           "make_fed_step",
           "mesh_axis_size", "process_count", "process_index", "row_block",
           "sharding"]
