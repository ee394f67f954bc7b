"""The 95th percentile (nearest rank) over every update of the window of
the milliseconds between the CUDA events recorded after consecutive
updates, the first from an event before the window: the pacing a
synchronous learner loop feels."""

import math


def read(rec):
    ms = sorted(rec["window"]["unit_ms"])
    if not ms:
        return None
    return ms[max(0, math.ceil(0.95 * len(ms)) - 1)]
