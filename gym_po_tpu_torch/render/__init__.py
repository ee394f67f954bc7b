"""Host-side renderers of the port's env states (NumPy; pygame only in
``human_view``)."""

from .renderers import (
    CELL_PX,
    COLORS,
    human_view,
    render,
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
    "tile_images",
    "human_view",
]
