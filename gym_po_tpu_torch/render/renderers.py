"""Host-side rendering, PyTorch port of :mod:`gym_po_tpu.render.renderers`.

The reference renders from mutable env internals with cv2/pygame (reference
``gym_po/envs/render_utils.py``, ``extended_taxi.py:289-342``,
``car_flag.py:146-278``).  Here, as in the JAX package, rendering is a pure
host function of a batched env state: the fields it reads are moved to
NumPy (from the card or the CPU), and the frame is drawn with NumPy.  An
optional pygame window is :func:`human_view` (pygame imported there).

Each ``render_*`` takes the environment (for its tables) and a *batched*
state, and returns a tiled uint8 RGB montage of the selected instances.
The articulated ant's renderers (``render_ant``, ``render_ant_scene``) wait
for the ant's port.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "CELL_PX",
    "COLORS",
    "tile_images",
    "render_taxi",
    "render_rooms",
    "render_crooms",
    "render_msrooms",
    "render_car",
    "render_tag",
    "render_heavenhell",
    "render_rocksample",
    "render",
    "human_view",
]

CELL_PX = 16

COLORS = {
    "wall": (40, 40, 40),
    "floor": (220, 220, 220),
    "pseudo_wall": (140, 140, 160),
    "agent": (200, 40, 40),
    "goal": (40, 170, 40),
    "taxi": (230, 200, 30),
    "taxi_full": (60, 190, 60),
    "passenger": (60, 90, 220),
    "destination": (190, 60, 190),
    "stairs_up": (230, 140, 40),
    "stairs_down": (100, 70, 160),
    "priest": (190, 60, 190),
    "heaven": (40, 170, 40),
    "hell": (200, 40, 40),
    "car": (230, 200, 30),
}


def _blank(rows: int, cols: int, color=(0, 0, 0)) -> np.ndarray:
    img = np.zeros((rows, cols, 3), np.uint8)
    img[:] = color
    return img


def _fill_cell(img: np.ndarray, y: int, x: int, color, px: int = CELL_PX, pad=1):
    img[y * px + pad : (y + 1) * px - pad, x * px + pad : (x + 1) * px - pad] = color


def _dot(img: np.ndarray, y: int, x: int, color, px: int = CELL_PX):
    q = px // 4
    img[y * px + q : (y + 1) * px - q, x * px + q : (x + 1) * px - q] = color


def tile_images(frames: Sequence[np.ndarray]) -> np.ndarray:
    """Tile B same-shaped frames into a near-square montage (capability of
    reference ``render_utils.py:63-88``, new layout algorithm)."""
    n = len(frames)
    cols = math.ceil(math.sqrt(n))
    rows = math.ceil(n / cols)
    h, w, c = frames[0].shape
    out = np.zeros((rows * h, cols * w, c), np.uint8)
    for i, f in enumerate(frames):
        r, cl = divmod(i, cols)
        out[r * h : (r + 1) * h, cl * w : (cl + 1) * w] = f
    return out


def _select(state_field, idx) -> np.ndarray:
    """The selected instances of a state field, as NumPy."""
    return state_field.detach().cpu().numpy()[idx]


def _indices(idx: Optional[Sequence[int]], default_n: int = 1) -> np.ndarray:
    return np.arange(default_n) if idx is None else np.asarray(idx)


# ------------------------------------------------------------------- taxi
def render_taxi(env, state, idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """PO-Taxi frame: walls from the bordered map, landmarks, taxi, passenger.

    Semantics match the reference's character overlay (extended_taxi.py:
    289-342: D destination, T taxi, P passenger, F full taxi), drawn both as
    colors and as text glyphs (reference render_utils.py:36-61 capability:
    landmark letters from the map string, T/F taxi status, P passenger,
    D destination).
    """
    from ..maps.taxi_maps import decode_state_np
    from .glyphs import draw_text_at

    t = env.tables
    idx = _indices(idx)
    s = _select(state.s, idx)
    r, c, p, d = decode_state_np(np.asarray(s, np.int64), t.cols, t.nlocs)
    frames = []
    px = CELL_PX

    def _cell_text(img, yy, xx, ch, color):
        # 5x7 glyph centered in the 16px cell
        draw_text_at(img, ch, (xx * px + (px - 5) // 2, yy * px + (px - 7) // 2),
                     color)

    for k in range(len(idx)):
        img = _blank(t.rows * px, t.cols * px, COLORS["wall"])
        for yy in range(t.rows):
            for xx in range(t.cols):
                _fill_cell(img, yy, xx, COLORS["floor"])
                code = t.hansen_grid[yy, xx]
                # paint thin wall edges from the 4-bit code (N=1,S=2,W=4,E=8)
                if code & 1:
                    img[yy * px : yy * px + 2, xx * px : (xx + 1) * px] = COLORS["wall"]
                if code & 2:
                    img[(yy + 1) * px - 2 : (yy + 1) * px, xx * px : (xx + 1) * px] = COLORS["wall"]
                if code & 4:
                    img[yy * px : (yy + 1) * px, xx * px : xx * px + 2] = COLORS["wall"]
                if code & 8:
                    img[yy * px : (yy + 1) * px, (xx + 1) * px - 2 : (xx + 1) * px] = COLORS["wall"]
        # landmark letters straight from the map string (R/G/Y/B...)
        for li in range(t.nlocs):
            ly, lx = t.np_locs[li]
            _cell_text(img, ly, lx, str(t.tgrid[ly, lx]), (120, 120, 130))
        dy, dx = t.np_locs[d[k]]
        _dot(img, dy, dx, COLORS["destination"])
        _cell_text(img, dy, dx, "D", (255, 255, 255))
        in_taxi = p[k] == t.nlocs
        _fill_cell(img, r[k], c[k], COLORS["taxi_full" if in_taxi else "taxi"], pad=3)
        if not in_taxi:
            py, pxx = t.np_locs[p[k]]
            _dot(img, py, pxx, COLORS["passenger"])
            _cell_text(img, py, pxx, "P", (255, 255, 255))
        # taxi status glyph last so it stays legible on the taxi cell
        _cell_text(img, r[k], c[k], "F" if in_taxi else "T", (0, 0, 0))
        frames.append(img)
    return tile_images(frames)


# ------------------------------------------------------------------ rooms
def _grid_frame(grid: np.ndarray) -> np.ndarray:
    """Base frame for a rooms-style int grid (-1 = wall, >=0 = room id)."""
    rows, cols = grid.shape
    img = _blank(rows * CELL_PX, cols * CELL_PX, COLORS["wall"])
    nroom = int(grid.max()) + 1 if grid.max() >= 0 else 1
    for yy in range(rows):
        for xx in range(cols):
            v = grid[yy, xx]
            if v >= 0:
                shade = 200 + int(40 * (v / max(nroom, 1)))
                _fill_cell(img, yy, xx, (shade, shade, min(shade + 10, 255)), pad=0)
    return img


def render_rooms(env, state, idx: Optional[Sequence[int]] = None) -> np.ndarray:
    idx = _indices(idx)
    base = _grid_frame(env.grid_np)
    agents = _select(state.agent_yx, idx)
    goals = _select(state.goal_yx, idx)
    frames = []
    for k in range(len(idx)):
        img = base.copy()
        _dot(img, int(goals[k, 0]), int(goals[k, 1]), COLORS["goal"])
        _fill_cell(img, int(agents[k, 0]), int(agents[k, 1]), COLORS["agent"], pad=4)
        frames.append(img)
    return tile_images(frames)


def render_crooms(env, state, idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """Continuous rooms: positions are float coords in grid units."""
    idx = _indices(idx)
    base = _grid_frame(env.grid_np)
    scale = CELL_PX / env.cell_size
    agents = _select(state.agent_yx, idx)
    goals = _select(state.goal_yx, idx)
    rad = max(CELL_PX // 4, 2)
    frames = []
    for k in range(len(idx)):
        img = base.copy()
        for pos, color in ((goals[k], COLORS["goal"]), (agents[k], COLORS["agent"])):
            cy, cx = (float(pos[0]) * scale, float(pos[1]) * scale)
            y0, y1 = int(max(cy - rad, 0)), int(min(cy + rad, img.shape[0]))
            x0, x1 = int(max(cx - rad, 0)), int(min(cx + rad, img.shape[1]))
            img[y0:y1, x0:x1] = color
        frames.append(img)
    return tile_images(frames)


def render_msrooms(env, state, idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """Multistory FourRooms: floors side by side, stairs marked.

    The reference's msrooms render raises NotImplementedError
    (msrooms.py:430-432); this provides the capability.
    """
    from ..envs.msrooms import STAIR_DOWN, STAIR_UP, WALL

    idx = _indices(idx)
    grid = env.grid_np  # [Z, H, W]
    Z, H, W = grid.shape
    agents = _select(state.agent_zyx, idx)
    goals = _select(state.goal_zyx, idx)
    frames = []
    for k in range(len(idx)):
        floors = []
        for z in range(Z):
            img = _blank(H * CELL_PX, W * CELL_PX, COLORS["wall"])
            for yy in range(H):
                for xx in range(W):
                    v = grid[z, yy, xx]
                    if v == WALL:
                        continue
                    _fill_cell(img, yy, xx, COLORS["floor"], pad=0)
                    if v == STAIR_UP:
                        _dot(img, yy, xx, COLORS["stairs_up"])
                    elif v == STAIR_DOWN:
                        _dot(img, yy, xx, COLORS["stairs_down"])
            if goals[k, 0] == z:
                _dot(img, int(goals[k, 1]), int(goals[k, 2]), COLORS["goal"])
            if agents[k, 0] == z:
                _fill_cell(img, int(agents[k, 1]), int(agents[k, 2]), COLORS["agent"], pad=4)
            floors.append(img)
        frames.append(np.concatenate(floors, axis=1))
    return tile_images(frames)


# -------------------------------------------------------------------- car
def render_car(env, state, idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """Car-Flag number line: car, heaven/hell flags, priest window
    (capability of reference car_flag.py:146-278, new minimal layout)."""
    idx = _indices(idx)
    W, H = 320, 48
    lo, hi = -1.2, 1.2

    def to_px(x: float) -> int:
        return int((x - lo) / (hi - lo) * (W - 1))

    pos = _select(state.pos, idx)
    heaven = _select(state.heaven, idx)
    priest = _select(state.priest, idx)
    frames = []
    for k in range(len(idx)):
        img = _blank(H, W, (15, 15, 20))
        img[H // 2 : H // 2 + 2, to_px(-1.1) : to_px(1.1)] = (120, 120, 120)
        # priest window
        img[H // 2 - 2 : H // 2 + 4, to_px(float(priest[k]) - 0.2) : to_px(float(priest[k]) + 0.2)] = COLORS["priest"]
        # heaven / hell flags
        hx = to_px(float(heaven[k]))
        img[H // 4 : 3 * H // 4, hx - 2 : hx + 2] = COLORS["heaven"]
        ex = to_px(-float(heaven[k]))
        img[H // 4 : 3 * H // 4, ex - 2 : ex + 2] = COLORS["hell"]
        cx = to_px(float(pos[k]))
        img[H // 2 - 6 : H // 2 + 6, max(cx - 4, 0) : cx + 4] = COLORS["car"]
        frames.append(img)
    return tile_images(frames)


# ------------------------------------------------------------- tag arenas
def render_tag(env, state, idx=None) -> np.ndarray:
    """TagContinuous arena: cage, visibility ring, agent, target."""
    idx = _indices(idx)
    SCALE, HALF = 24, 5.0
    size = int(2 * HALF * SCALE)

    def to_px(v):
        return int((float(v) + HALF) * SCALE)

    agents = _select(state.agent_xy, idx)
    targets = _select(state.target_xy, idx)
    frames = []
    for k in range(len(idx)):
        img = _blank(size, size, (15, 15, 20))
        c = to_px(-4.5), to_px(4.5)
        img[c[0]:c[1], c[0]:c[0]+2] = COLORS["wall"]
        img[c[0]:c[1], c[1]-2:c[1]] = COLORS["wall"]
        img[c[0]:c[0]+2, c[0]:c[1]] = COLORS["wall"]
        img[c[1]-2:c[1], c[0]:c[1]] = COLORS["wall"]
        ay, ax = to_px(agents[k, 1]), to_px(agents[k, 0])
        ty, tx = to_px(targets[k, 1]), to_px(targets[k, 0])
        img[max(ty-4,0):ty+4, max(tx-4,0):tx+4] = COLORS["goal"]
        img[max(ay-5,0):ay+5, max(ax-5,0):ax+5] = COLORS["agent"]
        frames.append(img)
    return tile_images(frames)


def render_heavenhell(env, state, idx=None) -> np.ndarray:
    """HeavenHellContinuous T-maze: free space, sites, agent."""
    from ..envs.tag import BAR, HH_SITES, STEM

    idx = _indices(idx)
    SCALE = 16
    X0, X1, Y0, Y1 = -9.0, 9.0, -2.5, 9.0
    wpx, hpx = int((X1 - X0) * SCALE), int((Y1 - Y0) * SCALE)

    def to_px(x, y):
        return int((y - Y0) * SCALE), int((x - X0) * SCALE)

    agents = _select(state.agent_xy, idx)
    heaven_right = _select(state.heaven_right, idx)
    frames = []
    for k in range(len(idx)):
        img = _blank(hpx, wpx, COLORS["wall"])
        for (xl, xh, yl, yh) in (STEM, BAR):
            r0, c0 = to_px(xl, yl)
            r1, c1 = to_px(xh, yh)
            img[r0:r1, c0:c1] = COLORS["floor"]
        for i, site in enumerate(HH_SITES):
            r, c = to_px(site[0], site[1])
            right_is_heaven = bool(heaven_right[k])
            color = (
                COLORS["priest"] if i == 2
                else COLORS["heaven"] if (i == 1) == right_is_heaven
                else COLORS["hell"]
            )
            img[max(r-5,0):r+5, max(c-5,0):c+5] = color
        r, c = to_px(agents[k, 0], agents[k, 1])
        img[max(r-4,0):r+4, max(c-4,0):c+4] = COLORS["agent"]
        frames.append(img)
    return tile_images(frames)


# --------------------------------------------------------------- dispatch
def render_rocksample(env, state, idx=None) -> np.ndarray:
    """RockSample(n,k) frame: grid, rocks colored by latent quality, rover,
    exit column on the east edge (sample-and-exit task, Smith & Simmons)."""
    idx = _indices(idx)
    pos = _select(state.pos_yx, idx)
    good = _select(state.rock_good, idx)
    frames = []
    for k in range(len(idx)):
        img = _blank(env.rows * CELL_PX, (env.cols + 1) * CELL_PX,
                     COLORS["wall"])
        for yy in range(env.rows):
            for xx in range(env.cols):
                _fill_cell(img, yy, xx, COLORS["floor"], pad=1)
            _fill_cell(img, yy, env.cols, COLORS["goal"], pad=1)  # exit strip
        for j, (ry, rx) in enumerate(np.asarray(env.rock_positions_np)):
            color = COLORS["goal"] if bool(good[k, j]) else COLORS["hell"]
            _dot(img, int(ry), int(rx), color)
        _fill_cell(img, int(pos[k, 0]), int(pos[k, 1]), COLORS["agent"], pad=4)
        frames.append(img)
    return tile_images(frames)


def render(env, state, idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """Dispatch on env type."""
    from ..envs.car_flag import CarFlag
    from ..envs.crooms import CRooms
    from ..envs.msrooms import MultistoryFourRooms
    from ..envs.rooms import Rooms
    from ..envs.rocksample import RockSample
    from ..envs.tag import HeavenHellContinuous, TagContinuous
    from ..envs.taxi import Taxi

    if isinstance(env, Taxi):
        return render_taxi(env, state, idx)
    if isinstance(env, Rooms):
        return render_rooms(env, state, idx)
    if isinstance(env, CRooms):
        return render_crooms(env, state, idx)
    if isinstance(env, MultistoryFourRooms):
        return render_msrooms(env, state, idx)
    if isinstance(env, CarFlag):
        return render_car(env, state, idx)
    if isinstance(env, TagContinuous):
        return render_tag(env, state, idx)
    if isinstance(env, HeavenHellContinuous):
        return render_heavenhell(env, state, idx)
    if isinstance(env, RockSample):
        return render_rocksample(env, state, idx)
    raise TypeError(f"No renderer for {type(env).__name__}")


def human_view(img: np.ndarray, window=None):
    """Blit a frame to a pygame window (reference 'human' mode capability)."""
    import pygame

    if window is None:
        pygame.init()
        window = pygame.display.set_mode((img.shape[1], img.shape[0]))
    sfc = pygame.surfarray.make_surface(img.swapaxes(0, 1))
    window.blit(sfc, (0, 0))
    pygame.display.update()
    return window
