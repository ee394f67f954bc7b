"""Work floors of one PPO update on the ant tag configuration, from
shapes alone.

* The network: the observation (``qpos[2:]``, ``qvel``, the target's xy:
  29 floats) through the MLP to 8 action means and a value
  (``floors/mlp.py``).
* One constrained forward of the ant, per env: its inputs read once and
  outputs written once (qpos 15, qvel 14, control 8, warm start 14 in;
  acceleration 14 and warm start 14 out; 4 bytes each), and the dense
  linear algebra that its semantics fix: the mass matrix's Cholesky
  factor (nv^3 / 6 multiply-adds) and a solve (nv^2) for the smooth
  acceleration, and again in each of the configured Newton iterations.
  An RK4 step runs four forwards, an env step ``frame_skip`` RK4 steps.
"""

from portbench.floors.mlp import update_flops

NQ, NV, NU = 15, 14, 8


def floor(config, traffic):
    kw = config["env_kwargs"]
    B, T = traffic["num_envs"], traffic["rollout_steps"]
    stages = {"rk4": 4, "euler": 1}[kw["integrator"]]
    fwd_bytes = 4 * (NQ + NV + NU + NV + 2 * NV)
    fwd_flops = 2 * (1 + kw["solver_iters"]) * (NV ** 3 // 6 + NV * NV)
    return {"flops": update_flops(NQ - 2 + NV + 2, traffic["hidden"], NU, False,
                                  B * T, traffic["epochs"]),
            "dtype": traffic["compute_dtype"], "per": "update",
            "forward": {"bytes": B * fwd_bytes, "flops": B * fwd_flops},
            "forwards_per_update": T * kw["frame_skip"] * stages}
