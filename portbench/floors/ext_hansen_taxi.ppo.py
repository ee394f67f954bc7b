"""Model FLOPs of one PPO update on the Taxi configuration: the network
reads the discrete observation (``floors/taxi.py``), five actions
(``floors/mlp.py``)."""

from portbench.floors.mlp import update_flops
from portbench.floors.taxi import n_obs


def floor(config, traffic):
    rows = traffic["num_envs"] * traffic["rollout_steps"]
    return {"flops": update_flops(n_obs(config), traffic["hidden"], 5, True, rows,
                                  traffic["epochs"]),
            "dtype": traffic["compute_dtype"], "per": "update"}
