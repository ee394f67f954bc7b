from .networks import (
    ActorCritic,
    entropy,
    log_prob,
    make_actor_critic,
    params_from_flax,
    sample_action,
)

__all__ = [
    "ActorCritic",
    "make_actor_critic",
    "params_from_flax",
    "sample_action",
    "log_prob",
    "entropy",
]
