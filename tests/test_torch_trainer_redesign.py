"""What the redesigned CRooms Q trainer [14] and MultistoryFourRooms rollout
[6] kernels rely on, held on the CPU.

* [14] sums each step's updates at the compact index
  ``a * slab_stride(n_obs) + obs`` and maps it back to the flat table by an
  invariant divisor (``table_index``): a bijection onto the entries that
  are used.
* Both kernels draw some sites only where they are needed: [14] the wall
  resample's normals (sites 8-11) where an env hits a wall and the agent
  respawn (site 12) where its episode ends, [6] its respawns where an
  episode ends.  Their twins draw every site every step, so the kernels
  equal the twins only if the twins' results do not depend on the draws
  that the kernels skip: a tape changed at exactly those draws leaves the
  twins' outputs unchanged.  The masks come from a replay through the
  env steps (``CRoomsDynamics.move``, ``MSRoomsDynamics.move``) during the
  twins' own run, the twins untouched.
* [14] loads its table adding ``+ 0`` to every entry, as the twin's
  whole-table add does: on a table holding -0 entries the twin agrees with
  the JAX kernel (interpreted, on a tape), sign of zero included.

The kernels against the twins on the card are in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gym_po_tpu as gpt
import gym_po_tpu_torch as gpt_torch
from gym_po_tpu.ops import make_fused_q_trainer_crooms as jax_trainer
from gym_po_tpu.ops import q_to_banks
from gym_po_tpu_torch.ops import (
    bank_geometry,
    kernel_rng,
    make_fused_msrooms_rollout,
    make_fused_q_trainer_crooms,
)
from gym_po_tpu_torch.ops.crooms_dynamics import CRoomsDynamics
from gym_po_tpu_torch.ops.fused_q_crooms import slab_stride, table_index
from gym_po_tpu_torch.ops.msrooms_dynamics import MSRoomsDynamics

from _tape import make_tape

W = 128
_jlog, _jcos = jax.jit(jnp.log), jax.jit(jnp.cos)


def _xla(fn):
    return lambda x: torch.from_numpy(np.array(fn(x.numpy())))


@pytest.fixture
def xla_libm(monkeypatch):
    """The twins' Box-Muller through XLA's CPU log and cos."""
    monkeypatch.setattr(kernel_rng, "_log", _xla(_jlog))
    monkeypatch.setattr(kernel_rng, "_cos", _xla(_jcos))


# ---------------------------------------------------------- [14]'s apply
@pytest.mark.parametrize("A", [4, 8])
@pytest.mark.parametrize("n_obs", [1, 127, 128, 200, 512])
def test_compact_index_maps_onto_the_used_entries(A, n_obs):
    """Every compact word of every action row, padding included, maps to a
    distinct entry of the flat table; the used words (obs < n_obs) map to
    exactly ``a * nsp + obs``."""
    nsb, nb = bank_geometry(n_obs, A)
    nsp, nq = nsb * W, nb * W
    no = slab_stride(n_obs)
    c = torch.arange(A * no, dtype=torch.int64)
    idx = table_index(c, n_obs, nsp)
    assert int(idx.min()) >= 0 and int(idx.max()) < nq
    assert torch.unique(idx).numel() == idx.numel()
    a, obs = c // no, c % no
    assert torch.equal(idx, a * nsp + obs)
    used = obs < n_obs
    want = (torch.arange(A)[:, None] * nsp + torch.arange(n_obs)).reshape(-1)
    assert torch.equal(torch.sort(idx[used]).values, want)


# ------------------------------------------------------- the skipped draws
def _crooms_trainer_case(time_limit=6, B=2048, K=12, **kw):
    env = gpt_torch.make("CRooms-v0", action_type="ordinal",
                         time_limit=time_limit, device="cpu", **kw)
    run = make_fused_q_trainer_crooms(env, B, K, average_duplicates=True,
                                      rng_tape=True)
    _, st = env.reset_vec(torch.Generator().manual_seed(3), B)
    z = torch.zeros(B // W, W)
    s4 = [st.agent_yx[:, 0].reshape(-1, W).contiguous(),
          st.agent_yx[:, 1].reshape(-1, W).contiguous(), z, z]
    q = 0.1 * torch.randn((32, W), generator=torch.Generator().manual_seed(4))
    return run, s4, q, K


def _record_crooms_moves(monkeypatch):
    """Per step of the twin's run, ``(hit a wall, episode ended)`` per env:
    a hit is where the move's result depends on the resample normals (NaN
    normals make the resampled position NaN exactly there)."""
    orig = CRoomsDynamics.move
    steps = []

    def move(self, tab, py, px, vy, vx, ay, ax, nry, nrx, gy, gx, elapsed):
        mv = orig(self, tab, py, px, vy, vx, ay, ax, nry, nrx, gy, gx, elapsed)
        nan = torch.full_like(nry, float("nan"))
        probe = orig(self, tab, py, px, vy, vx, ay, ax, nan, nan, gy, gx, elapsed)
        steps.append((torch.isnan(probe.py), mv.reset))
        return mv

    monkeypatch.setattr(CRoomsDynamics, "move", move)
    return steps


def _redraw(tape_sites, site, keep, gen):
    """Tape words of ``site`` ([K, B] view) replaced where ``keep`` is
    false, with fresh seeded words."""
    fresh = torch.randint(-2**31, 2**31, keep.shape, generator=gen,
                          dtype=torch.int32)
    tape_sites[site] = torch.where(keep, tape_sites[site], fresh)


@pytest.mark.parametrize("kw", [{}, {"use_velocity": True},
                                {"agent_xy": (1, 1)}])
def test_crooms_trainer_twin_ignores_the_draws_the_kernel_skips(monkeypatch, kw):
    """[14]: sites 8-11 changed where the env did not hit a wall, site 12
    where its episode did not end: the twin's positions, velocities, Q and
    reward sums are unchanged.  The same change where it did hit a wall
    changes them (the masks are the right ones)."""
    run, s4, q, K = _crooms_trainer_case(**kw)
    B = s4[0].numel()
    tape = torch.as_tensor(make_tape(np.random.default_rng(5), run.n_sites, K,
                                     B // W))
    steps = _record_crooms_moves(monkeypatch)
    want = run(7, 0.1, 0.3, *s4, q, tape)
    assert len(steps) == K and run.launches == 0
    hit = torch.stack([h for h, _ in steps])
    ended = torch.stack([r for _, r in steps])
    assert 0.01 < hit.double().mean() < 0.9 and ended.any()
    sites = tape.clone().view(run.n_sites, K, B)
    gen = torch.Generator().manual_seed(6)
    for site in range(8, 12):
        _redraw(sites, site, hit, gen)
    if run.n_sites == 13:
        _redraw(sites, 12, ended, gen)
    got = run(7, 0.1, 0.3, *s4, q, sites.view(run.tape_shape))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    sites = tape.clone().view(run.n_sites, K, B)
    _redraw(sites, 8, ~hit, gen)
    moved = run(7, 0.1, 0.3, *s4, q, sites.view(run.tape_shape))
    assert not torch.equal(moved[0], want[0])


def _msrooms_case(kw, B=1024, K=24, rows_per_tile=2):
    env = gpt_torch.make("MultistoryFourRooms-v0", grid_z=3, time_limit=5,
                         device="cpu", **kw)
    run = make_fused_msrooms_rollout(env, B, K, rows_per_tile=rows_per_tile,
                                     episode_stats=True, rng_tape=True)
    rng = np.random.default_rng(8)
    walk = np.flatnonzero(env.grid_np.reshape(-1) > 0)
    agent = rng.choice(walk, B).astype(np.int32)
    goal = rng.choice(env.valid_goal_states, B).astype(np.int32)
    if env.fixed_goal_zyx is not None:
        goal[:] = np.ravel_multi_index(tuple(env.fixed_goal_zyx), env.grid_np.shape)
    return run, torch.as_tensor(agent).reshape(-1, W), torch.as_tensor(goal).reshape(-1, W)


@pytest.mark.parametrize("kw", [{"goal_xyz": None}, {},
                                {"goal_xyz": None, "agent_xyz": (1, 1, 0)}],
                         ids=["random-both", "random-agent", "random-goal"])
def test_msrooms_rollout_twin_ignores_the_draws_the_kernel_skips(monkeypatch, kw):
    """[6]: the respawn sites (3, and 4 when both spawns are drawn) changed
    where the episode did not end leave every output of the twin unchanged
    (two tape tiles, so the tile layout is exercised); changed where it did
    end, they change the outputs."""
    run, agent, goal = _msrooms_case(kw)
    B, R, K = agent.numel(), 2, 24
    grid = B // (R * W)
    tape = torch.as_tensor(make_tape(np.random.default_rng(9), run.n_sites, K,
                                     R, grid=grid))
    orig = MSRoomsDynamics.move
    resets = []

    def move(self, *args):
        mv = orig(self, *args)
        resets.append(mv.reset)
        return mv

    monkeypatch.setattr(MSRoomsDynamics, "move", move)
    want = run(3, agent, goal, tape)
    assert len(resets) == K and run.launches == 0
    # [K, B] in env order (tile, row, lane) -> the tape's [tile, K, R, W]
    ended = torch.stack(resets).view(K, grid, R, W).permute(1, 0, 2, 3)
    assert 0 < ended.double().mean() < 0.5
    respawn_sites = range(3, run.n_sites)  # goal, then agent, where drawn
    assert len(respawn_sites) == ("goal_xyz" in kw) + ("agent_xyz" not in kw)
    gen = torch.Generator().manual_seed(10)

    def redraw(keep):
        t5 = tape.clone().view(grid, run.n_sites, K, R, W)
        for site in respawn_sites:
            fresh = torch.randint(-2**31, 2**31, keep.shape, generator=gen,
                                  dtype=torch.int32)
            t5[:, site] = torch.where(keep, t5[:, site], fresh)
        return t5.view(run.tape_shape)

    got = run(3, agent, goal, redraw(ended))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    moved = run(3, agent, goal, redraw(~ended))
    assert not all(torch.equal(g, w) for g, w in zip(moved, want))


# ------------------------------------------------------------ -0 entries
def test_crooms_trainer_twin_turns_negative_zeros_as_the_jax_kernel(xla_libm):
    """A table whose zero entries are -0 (every padding entry, and a
    scattering of used ones): the twin and the JAX kernel (interpreted, on
    a tape) agree, Q to rtol 1e-5 and every zero with the same sign; the
    kernel's load of q_in + 0 is what makes it agree with the twin."""
    kw = dict(action_type="ordinal", time_limit=8)
    je = gpt.make("CRooms-v0", **kw)
    te = gpt_torch.make("CRooms-v0", device="cpu", **kw)
    B, K, lr, eps = 1024, 6, 0.2, 0.3
    A, n_obs = int(je.num_actions), int(je.observation_space.n)
    _, st = je.reset_vec(jax.random.PRNGKey(8), B)
    s4 = [np.asarray(st.agent_yx[:, 0]), np.asarray(st.agent_yx[:, 1]),
          np.zeros(B), np.zeros(B)]
    s4 = [np.array(x, np.float32).reshape(-1, W) for x in s4]
    rng = np.random.default_rng(12)
    q0 = np.full((512, A), -0.0, np.float32)
    used = rng.normal(scale=0.1, size=(n_obs, A)).astype(np.float32)
    used[rng.random((n_obs, A)) < 0.3] = -0.0
    q0[:n_obs] = used
    qb0 = q_to_banks(q0)
    assert np.signbit(qb0[qb0 == 0]).all() and (qb0 == 0).sum() > 1000
    jrun = jax_trainer(je, B, K, 0.9, average_duplicates=True, interpret=True,
                       rng_tape=True)
    trun = make_fused_q_trainer_crooms(te, B, K, 0.9, average_duplicates=True,
                                       rng_tape=True)
    tape = make_tape(rng, jrun.n_sites, K, B // W)
    jout = jrun(jnp.asarray([3], jnp.int32), lr, eps, *map(jnp.asarray, s4),
                jnp.asarray(qb0), jnp.asarray(tape))
    tout = trun(3, lr, eps, *map(torch.as_tensor, s4), torch.as_tensor(qb0),
                torch.as_tensor(tape))
    jq, tq = np.asarray(jout[4]), tout[4].numpy()
    np.testing.assert_allclose(tq, jq, rtol=1e-5, atol=1e-7)
    zero = (jq == 0) & (tq == 0)
    assert zero.sum() > 1000
    np.testing.assert_array_equal(np.signbit(tq[zero]), np.signbit(jq[zero]))
    assert not np.signbit(tq[zero]).any()
    for name, j, t in zip("py px vy vx".split(), jout, tout):
        np.testing.assert_array_equal(np.asarray(j), t.numpy(), err_msg=name)
