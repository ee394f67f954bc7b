from .env import Environment, EnvState, StepOut
from .spaces import Box, Discrete, Space, batch_space

__all__ = [
    "Environment",
    "EnvState",
    "StepOut",
    "Space",
    "Discrete",
    "Box",
    "batch_space",
]
