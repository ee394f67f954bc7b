from .networks import (
    ActorCritic,
    entropy,
    log_prob,
    make_actor_critic,
    params_from_flax,
    sample_action,
)
from .qlearning import (
    QConfig,
    fused_actor_critic,
    fused_q_learning,
    greedy_policy,
    q_learning,
    td_update,
)

__all__ = [
    "ActorCritic",
    "make_actor_critic",
    "params_from_flax",
    "sample_action",
    "log_prob",
    "entropy",
    "QConfig",
    "q_learning",
    "td_update",
    "greedy_policy",
    "fused_q_learning",
    "fused_actor_critic",
]
