from .env import Environment, EnvState, StepOut, map_tensors
from .spaces import Box, Discrete, Space, batch_space

__all__ = [
    "Environment",
    "EnvState",
    "StepOut",
    "map_tensors",
    "Space",
    "Discrete",
    "Box",
    "batch_space",
]
