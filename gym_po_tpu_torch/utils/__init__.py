from .actions import (
    ACTIONS_CARDINAL,
    ACTIONS_ORDINAL,
    exec_action_np,
    failure_cumsum,
    failure_matrix,
    make_exec_action,
)

__all__ = [
    "ACTIONS_ORDINAL",
    "ACTIONS_CARDINAL",
    "failure_matrix",
    "failure_cumsum",
    "exec_action_np",
    "make_exec_action",
]
