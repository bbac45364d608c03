"""The decoder models of the port: the attention families (GQA or MLA
attention, a SwiGLU or MoE MLP), the hybrid attention + Mamba block and
xLSTM's recurrent pairs (``models/ssm.py``)."""
from repro_torch.models.model import (decode_step, decode_step_slots,
                                      forward, init_cache, init_params,
                                      init_slot_cache, lm_loss,
                                      lm_loss_labeled, prefill)

__all__ = ["decode_step", "decode_step_slots", "forward", "init_cache",
           "init_params", "init_slot_cache", "lm_loss", "lm_loss_labeled",
           "prefill"]
