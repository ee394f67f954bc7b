from .observations import (
    make_rooms_obs,
    n_discrete_states,
    n_room_states,
    state_grid,
)

__all__ = ["make_rooms_obs", "n_discrete_states", "state_grid", "n_room_states"]
