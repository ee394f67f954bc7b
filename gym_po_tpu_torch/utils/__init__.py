from .actions import (
    ACTIONS_CARDINAL,
    ACTIONS_ORDINAL,
    exec_action_np,
    failure_cumsum,
    failure_matrix,
    make_exec_action,
)
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint

__all__ = [
    "ACTIONS_ORDINAL",
    "ACTIONS_CARDINAL",
    "failure_matrix",
    "failure_cumsum",
    "exec_action_np",
    "make_exec_action",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
]
