"""The decoder models of the port (dense GQA families)."""
from repro_torch.models.model import (decode_step, decode_step_slots,
                                      forward, init_cache, init_params,
                                      init_slot_cache, prefill)

__all__ = ["decode_step", "decode_step_slots", "forward", "init_cache",
           "init_params", "init_slot_cache", "prefill"]
