from .actions import (
    ACTIONS_CARDINAL,
    ACTIONS_ORDINAL,
    exec_action_np,
    failure_cumsum,
    failure_matrix,
    make_exec_action,
)
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .debug import assert_finite, checked
from .grid import (
    DIRECTIONS_2D,
    DIRECTIONS_3D,
    coord_to_flat,
    flat_to_coord,
    hansen_indices,
    surrounding_indices,
)
from .profiling import Timer, annotate, trace

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
    "trace",
    "annotate",
    "Timer",
    "checked",
    "assert_finite",
    "DIRECTIONS_2D",
    "DIRECTIONS_3D",
    "surrounding_indices",
    "hansen_indices",
    "flat_to_coord",
    "coord_to_flat",
]
