"""Per-agent optimizers over (K, d) parameter stacks."""
