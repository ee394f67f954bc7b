from .vec_env import (
    EpisodeStatsState,
    RecordEpisodeStatistics,
    Transition,
    VecEnv,
    rollout,
)
from .chunked import DISPATCH_BATCH, chunked_rollout, make_chunked_step

__all__ = [
    "VecEnv",
    "Transition",
    "rollout",
    "RecordEpisodeStatistics",
    "EpisodeStatsState",
    "chunked_rollout",
    "make_chunked_step",
    "DISPATCH_BATCH",
]
