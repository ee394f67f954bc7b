"""``gym_po_tpu_torch.physics.engine.step`` against the JAX package's
``engine.step`` (``pipeline="array"``) at float64 on the CPU: RK4 and
semi-implicit Euler, frame_skip 2, 15 Newton iterations, from the same
contact states and warm starts.  ``qpos``, ``qvel`` and the warm start
carried out of the last solve must agree to 1e-8 (each JAX step compiled
once, ``jax.vmap``-ed over the batch).  The integrator's behavioural
tests are in ``test_torch_physics_behaviour.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gym_po_tpu.physics import ant_model as jam
from gym_po_tpu.physics import engine as jeng
from gym_po_tpu_torch.physics import ant_model as tam
from gym_po_tpu_torch.physics import engine as teng

from test_torch_physics import contact_states, one_thread  # noqa: F401


@pytest.mark.parametrize("integrator", ["rk4", "euler"])
def test_step_matches_jax(integrator):
    jm = jam.make_ant_model(jam.TAG_WALLS)
    tm = tam.make_ant_model(tam.TAG_WALLS)
    qpos, qvel, ctrl, warm = contact_states(8, 5, "tag")
    with jax.enable_x64(True):
        def one(q, v, w, c):
            return jeng.step(jm, jeng.PhysicsState(q, v, w), c, frame_skip=2,
                             iters=15, integrator=integrator, pipeline="array")

        want = jax.jit(jax.vmap(one))(*(jnp.asarray(x)
                                         for x in (qpos, qvel, warm, ctrl)))
    got = teng.step(tm, teng.PhysicsState.from_numpy(qpos, qvel, warm, "cpu"),
                    torch.as_tensor(ctrl), frame_skip=2, iters=15,
                    integrator=integrator)
    for name, g, w in zip(("qpos", "qvel", "warm"), got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8,
                                   atol=1e-8, err_msg=name)
    # the warm start matters: without it the same 15 iterations end
    # elsewhere (the solve is not converged from a cold start everywhere)
    cold = teng.step(tm, teng.PhysicsState.from_numpy(qpos, qvel, 0 * warm, "cpu"),
                     torch.as_tensor(ctrl), frame_skip=1, iters=1,
                     integrator=integrator)
    warm1 = teng.step(tm, teng.PhysicsState.from_numpy(qpos, qvel, warm, "cpu"),
                      torch.as_tensor(ctrl), frame_skip=1, iters=1,
                      integrator=integrator)
    assert (cold.warm - warm1.warm).abs().max() > 1e-6
