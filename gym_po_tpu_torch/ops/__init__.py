from .fused_taxi import make_fused_taxi_rollout, state_policy_table
from .kernel_rng import KernelRNG, philox4x32_10

__all__ = [
    "make_fused_taxi_rollout",
    "state_policy_table",
    "KernelRNG",
    "philox4x32_10",
]
