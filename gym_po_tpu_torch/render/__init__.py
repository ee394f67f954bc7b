"""Host-side renderers of the port's env states (NumPy; pygame only in
``human_view``, mujoco only in ``render_ant_scene``)."""

from .renderers import (
    CELL_PX,
    COLORS,
    human_view,
    render,
    render_ant,
    render_ant_scene,
    render_car,
    render_heavenhell,
    render_tag,
    render_crooms,
    render_msrooms,
    render_rocksample,
    render_rooms,
    render_taxi,
    tile_images,
)

__all__ = [
    "CELL_PX",
    "COLORS",
    "render",
    "render_taxi",
    "render_rooms",
    "render_crooms",
    "render_msrooms",
    "render_car",
    "render_tag",
    "render_heavenhell",
    "render_rocksample",
    "render_ant",
    "render_ant_scene",
    "tile_images",
    "human_view",
]
