"""RL substrate: batched environments, MLP policy, rollouts, estimators."""
