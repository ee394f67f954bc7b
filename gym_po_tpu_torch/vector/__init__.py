from .vec_env import (
    EpisodeStatsState,
    RecordEpisodeStatistics,
    Transition,
    VecEnv,
    rollout,
)

__all__ = [
    "VecEnv",
    "Transition",
    "rollout",
    "RecordEpisodeStatistics",
    "EpisodeStatsState",
]
