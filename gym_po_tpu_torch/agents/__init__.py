from .networks import (
    ActorCritic,
    AdamState,
    adam_state_from_optax,
    entropy,
    log_prob,
    make_actor_critic,
    params_from_flax,
    sample_action,
)
from .ppo import PPOConfig, TrainState, init_train_state, make_train_step, train
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
    "AdamState",
    "adam_state_from_optax",
    "sample_action",
    "log_prob",
    "entropy",
    "QConfig",
    "q_learning",
    "td_update",
    "greedy_policy",
    "fused_q_learning",
    "fused_actor_critic",
    "PPOConfig",
    "TrainState",
    "init_train_state",
    "make_train_step",
    "train",
]
