"""The coordinate-wise reduce body and the gossip reduces of the cw*
agreement rounds (CUDA kernels + plain)."""
from repro_torch.kernels.gossip_reduce.cw_reduce import (MODES, check_mode,
                                                         cw_reduce_plain)
from repro_torch.kernels.gossip_reduce.gossip_reduce import (
    gossip_reduce, gossip_reduce_plain, neighbor_reduce,
    neighbor_reduce_plain)

__all__ = ["MODES", "check_mode", "cw_reduce_plain", "gossip_reduce",
           "gossip_reduce_plain", "neighbor_reduce", "neighbor_reduce_plain"]
