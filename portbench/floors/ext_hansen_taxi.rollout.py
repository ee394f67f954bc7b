"""Work floor of one call of the fused Taxi rollout, from shapes alone.

Per env-step the env's semantics and the draw contract need: the Philox
blocks of the step's draw sites (a random action and the step's task and
reset draws), the reduction of each draw to ``[0, n)``, and the state
codec (``floors/taxi.py``).  All run on the integer multiply pipe.
Bytes: each env's state read and its next state and reward sum written
once, 4 bytes each.
"""

from portbench.floors.taxi import CODEC_MULS, PHILOX_MULS, REDUCE_MULS, step_sites


def floor(config, traffic):
    B, K = int(traffic["num_envs"]), int(traffic["num_steps"])
    sites = 1 + step_sites(config["map"])
    blocks = -(-sites // 4)
    per_step = blocks * PHILOX_MULS + sites * REDUCE_MULS + CODEC_MULS
    return {"int_mul": B * K * per_step, "bytes": 12 * B,
            "per": "call", "muls_per_env_step": per_step}
