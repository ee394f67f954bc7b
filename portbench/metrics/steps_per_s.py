"""Env-steps (or train-steps) of every unit of the window over the
window's seconds, which end when the device has finished the last unit
(host clock)."""


def read(rec):
    win = rec["window"]
    return win["work"] / win["window_s"] if win["window_s"] > 0 else None
