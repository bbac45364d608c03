"""RL substrate: batched environments, MLP policy, rollouts, estimators.

The reference's package-level names, each in the port's form: the
environments reset from a ``torch.Generator``, ``init_mlp`` draws from
one, ``mlp_logits`` runs one MLP's layer dicts, and ``sample_batch``
draws a (K, n) batch of trajectories for K agents' flat θ from a
generator where the reference vmaps one parameter tree over keys.
"""
from repro_torch.rl.envs import Env, make_cartpole, make_env, make_lunarlander
from repro_torch.rl.gradient import (grad_estimate, importance_weights,
                                     step_log_probs, weighted_grad_estimate)
from repro_torch.rl.policy import init_mlp, mlp_logits
from repro_torch.rl.rollout import Trajectory, batch_return, sample_batch

__all__ = ["Env", "Trajectory", "batch_return", "grad_estimate",
           "importance_weights", "init_mlp", "make_cartpole", "make_env",
           "make_lunarlander", "mlp_logits", "sample_batch",
           "step_log_probs", "weighted_grad_estimate"]
