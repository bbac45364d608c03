"""Communication topologies for decentralized agreement."""
from repro_torch.topology.graphs import (Topology, make_topology,
                                         resolve_topology)

__all__ = ["Topology", "make_topology", "resolve_topology"]
