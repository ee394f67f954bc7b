"""Work floor of one call of the fused Q trainer on Taxi, from shapes
alone.

Per train-step: the Philox blocks of the step's draw sites (the explore
coin, a random action, then the step's task and reset draws), the
reduction of each draw to ``[0, n)`` (all but the 24-bit coin), the state
codec, and the Hansen index of the state and of the TD state (a codec
each) (``floors/taxi.py``).  Bytes: each env's state read, its next state
and reward sum written, 4 bytes each, and the table read and written
once.
"""

from portbench.floors.taxi import CODEC_MULS, PHILOX_MULS, REDUCE_MULS, n_obs, step_sites


def floor(config, traffic):
    B, K = int(traffic["num_envs"]), int(traffic["num_steps"])
    sites = 2 + step_sites(config["map"])
    blocks = -(-sites // 4)
    index = 2 * CODEC_MULS if config["hansen_obs"] else 0
    per_step = blocks * PHILOX_MULS + (sites - 1) * REDUCE_MULS + CODEC_MULS + index
    table = 5 * n_obs(config) * 4
    return {"int_mul": B * K * per_step, "bytes": 12 * B + 2 * table,
            "per": "call", "muls_per_train_step": per_step}
