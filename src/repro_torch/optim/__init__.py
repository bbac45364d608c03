"""Per-agent optimizers over (K, d) parameter stacks, and schedules."""
from repro_torch.optim.optimizers import (adam, cosine_schedule,
                                          get_optimizer, sgd)

__all__ = ["adam", "cosine_schedule", "get_optimizer", "sgd"]
