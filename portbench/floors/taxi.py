"""The Taxi arithmetic that the Taxi cells' floors share: the integer
multiplies of the draw contract and the state codec, and the sizes of
the map's state and observation spaces."""

#: 32x32->64-bit multiplies of a Philox4x32-10 block (10 rounds of two)
PHILOX_MULS = 20
#: a draw reduced to ``[0, n)``: a multiply-high and a multiply-back
REDUCE_MULS = 2
#: the state codec: decode two divisions (two multiplies each), encode two
CODEC_MULS = 6


def step_sites(rows) -> int:
    """Draw sites of one env step: the task's four, and the reset's two
    where every cell is navigable (else one: a navigable cell drawn)."""
    return 4 + (2 if not any("|" in r for r in rows) else 1)


def n_locs(rows) -> int:
    return sum(ch not in "| :" for r in rows for ch in r)


def n_obs(config) -> int:
    """Observations: Hansen's 16 wall codes, or the map's cells, times
    passenger places and destinations."""
    rows, nl = config["map"], n_locs(config["map"])
    cells = 16 if config["hansen_obs"] else len(rows) * len(rows[0])
    return cells * (nl + 1) * nl
