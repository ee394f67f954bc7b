"""AntTagPhysics / AntHeavenHellPhysics, the articulated ant POMDPs on the
port's rigid-body engine: PyTorch port of
:mod:`gym_po_tpu.envs.ant_physics`.

The reference environments (reference ``gym_po/envs/ant_tag.py``,
``ant_heaven_hell.py``) with the MuJoCo C substrate replaced by
:mod:`gym_po_tpu_torch.physics`: the same 8-DoF quadruped, RK4 at 0.02 s ×
frame_skip 15, the same task layer, batched over a leading env axis.

* **AntTagPhysics** (ant_tag.py:27-158): ±4.5 spawn cage inside ±5.25
  walls.  The target flees 0.5 per step {away, two orthogonals, stay},
  cancelled at the cage edge; it spawns ≥ 5.0 from the ant.  Obs (29) =
  qpos[2:] + qvel + target xy if within the visible radius, else zeros.
  A tag within 1.5 gives +1 and ends the episode.
* **AntHeavenHellPhysics** (ant_heaven_hell.py:29-137): T-maze, heaven at
  (±6.25, 6.0) by a coin flip per episode, the priest at (0, 6.0), radius
  2.0.  Obs (28) = qpos[2:] + qvel + the heaven side iff near the priest.
  Reaching heaven or hell gives ±1 and ends the episode.

Each step is stages that take their draws as arguments: :meth:`physics`
(the engine, ``frame_skip`` integrator steps), ``advance`` (the task: the
target's flee with its ``mode``, the tag or the arrival, the time limit),
``fresh`` (a new episode from its uniforms), :meth:`apply_reset`
(autoreset) and ``observe``.  ``step_vec`` composes them with draws from an
explicit ``torch.Generator`` and never waits on the host.  ``info`` holds
``terminal_state`` (the pre-reset state) and ``reset_mask``.

Physics knobs, as in the JAX package: ``solver_iters`` (Newton iterations
per integrator stage), ``ls_iters`` (line-search bisections), ``integrator``
(``"rk4"``, the reference's, or ``"euler"``), ``pipeline`` (``"scalar"``,
the default: on the card the per-env CUDA kernels of
:mod:`gym_po_tpu_torch.ops.ant_forward`, on the CPU the batched engine;
``"array"``: the batched engine on either).  The state is float32 and the
engine follows it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ..core import Box, Environment, EnvState
from ..core.env import _stack, _unstack
from ..physics import HEAVEN_HELL_WALLS, TAG_WALLS, make_ant_model
from ..physics.engine import INTEGRATORS, PIPELINES, PhysicsState
from ..physics.engine import step as physics_step
from ..utils.numerics import sqrt_rn

__all__ = [
    "AntTagPhysics",
    "AntTagPhysicsState",
    "AntHeavenHellPhysics",
    "AntHeavenHellPhysicsState",
    "move_target",
    "STAND_POSE",
    "SPAWN_CANDIDATES",
]

# nominal standing pose (the JAX package's envs/ant.py:_STAND_POSE)
STAND_POSE = np.array(
    [0.0, 0.0, 0.55, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, -1.0, 0.0, -1.0,
     0.0, 1.0], np.float32,
)
_NQ, _NV = 15, 14

CAGE = 4.5
VISIBLE_RADIUS = 3.0
TAG_RADIUS = 1.5
MIN_SPAWN_DIST = 5.0
TARGET_STEP = 0.5
# the JAX package's rejection loop: a first draw and at most 256 redraws
SPAWN_CANDIDATES = 257

HH_SITES = np.array([[-6.25, 6.0], [6.25, 6.0], [0.0, 6.0]], np.float32)
HH_RADIUS = 2.0


def _from_numpy(cls, fields, device):
    """A state dataclass from a mapping or object of numpy arrays (e.g. the
    JAX package's state through ``np.asarray``), dtypes kept."""
    get = fields.get if isinstance(fields, dict) else \
        (lambda name: getattr(fields, name))
    return cls(**{f.name: torch.as_tensor(np.array(get(f.name))).to(device)
                  for f in dataclasses.fields(cls)})


@dataclasses.dataclass(frozen=True)
class AntTagPhysicsState(EnvState):
    qpos: torch.Tensor       # f32 [..., 15]
    qvel: torch.Tensor       # f32 [..., 14]
    warm: torch.Tensor       # f32 [..., 14] solver warm start
    target_xy: torch.Tensor  # f32 [..., 2]

    @classmethod
    def from_numpy(cls, fields, device="cuda") -> "AntTagPhysicsState":
        """From the JAX package's ``AntTagPhysicsState`` (or a dict) of
        numpy arrays."""
        return _from_numpy(cls, fields, device)


@dataclasses.dataclass(frozen=True)
class AntHeavenHellPhysicsState(EnvState):
    qpos: torch.Tensor
    qvel: torch.Tensor
    warm: torch.Tensor
    heaven_right: torch.Tensor  # bool [...]

    @classmethod
    def from_numpy(cls, fields, device="cuda") -> "AntHeavenHellPhysicsState":
        """From the JAX package's ``AntHeavenHellPhysicsState`` (or a dict)
        of numpy arrays."""
        return _from_numpy(cls, fields, device)


def move_target(agent_xy: torch.Tensor, target_xy: torch.Tensor,
                mode: torch.Tensor) -> torch.Tensor:
    """The reference's flee rule (ant_tag.py:105-123), the JAX package's
    ``_move_target`` over leading axes: 0.5 {0 away, 1 and 2 the
    orthogonals, 3 stay}, cancelled at the cage edge; the target stays
    put at zero distance."""
    away = agent_xy - target_xy
    nrm = sqrt_rn((away * away).sum(-1, keepdim=True))
    safe = nrm > 1e-9
    away = torch.where(safe, away / torch.where(safe, nrm, 1.0), 0.0)
    ortho = torch.stack([away[..., 1], -away[..., 0]], -1)
    m = mode[..., None]
    step = torch.where(m == 0, -away, torch.where(
        m == 1, ortho, torch.where(m == 2, -ortho, torch.zeros_like(away))))
    new = target_xy + step * TARGET_STEP
    oob = (new.abs() > CAGE).any(-1, keepdim=True)
    return torch.where(oob | ~safe, target_xy, new)


class _AntPhysicsBase(Environment):
    """Shared physics plumbing; subclasses add the task layer."""

    def __init__(self, walls, time_limit: int, frame_skip: int,
                 solver_iters: int, integrator: str = "rk4",
                 ls_iters: int = 10, pipeline: str = "scalar",
                 device: Any = "cuda"):
        if integrator not in INTEGRATORS:
            raise ValueError(f"unknown integrator {integrator!r}")
        if pipeline not in PIPELINES:
            raise ValueError(f"unknown pipeline {pipeline!r}")
        self.model = make_ant_model(walls)
        self.time_limit = int(time_limit)
        self.frame_skip = int(frame_skip)
        self.solver_iters = int(solver_iters)
        self.ls_iters = int(ls_iters)
        self.pipeline = str(pipeline)
        self.integrator = str(integrator)
        self.device = torch.device(device)
        self._action_space = Box(-1.0, 1.0, (8,), dtype=torch.float32)
        self._stand = torch.as_tensor(STAND_POSE, device=self.device)

    @property
    def action_space(self) -> Box:
        return self._action_space

    @property
    def observation_space(self) -> Box:
        return self._observation_space

    def physics(self, qpos, qvel, warm, action):
        """``frame_skip`` integrator steps with the clipped action held →
        (qpos, qvel, warm)."""
        out = physics_step(self.model, PhysicsState(qpos, qvel, warm),
                           torch.clamp(action, -1.0, 1.0),
                           frame_skip=self.frame_skip, iters=self.solver_iters,
                           integrator=self.integrator, ls_iters=self.ls_iters,
                           pipeline=self.pipeline)
        return out.qpos, out.qvel, out.warm

    def spawn_qpos(self, xy: torch.Tensor) -> torch.Tensor:
        """The standing pose at ``xy [B, 2]``."""
        return torch.cat([xy, self._stand[2:].expand(xy.shape[0], _NQ - 2)], -1)

    def _core_obs(self, qpos, qvel):
        return torch.cat([qpos[..., 2:], qvel], -1)

    def apply_reset(self, state, mask: torch.Tensor, fresh):
        """Autoreset: each field from ``fresh`` where ``mask``, else from
        ``state``."""
        def pick(n, o):
            return torch.where(mask.reshape(mask.shape + (1,) * (o.dim() - mask.dim())),
                               n, o)
        return dataclasses.replace(state, **{
            f.name: pick(getattr(fresh, f.name), getattr(state, f.name))
            for f in dataclasses.fields(state)})

    def observe_vec(self, state) -> torch.Tensor:
        return self.observe(state)  # written over any leading axes

    # -------------------------------------------------------------- protocol
    def reset_env(self, generator: torch.Generator):
        obs, state = self.reset_vec(generator, 1)
        return obs[0], _unstack(state, 0)

    def step_env(self, generator: torch.Generator, state, action: torch.Tensor):
        obs, st, rew, done, trunc, info = self.step_vec(
            generator, _stack([state]), action.reshape(1, -1))
        info = {"terminal_state": _unstack(info["terminal_state"], 0),
                "reset_mask": info["reset_mask"][0]}
        return obs[0], _unstack(st, 0), rew[0], done[0], trunc[0], info


class AntTagPhysics(_AntPhysicsBase):
    """Articulated ant tag (the full reference env on the port's engine).

    ``visible_radius``: the target's visibility cutoff (reference
    ant_tag.py:77-86 uses 3.0).  ``device``: the card by default; pass
    ``"cpu"`` for the CPU."""

    name = "AntTagPhysics-v0"

    def __init__(self, time_limit: int = 500, frame_skip: int = 15,
                 solver_iters: int = 8, integrator: str = "rk4",
                 ls_iters: int = 10, pipeline: str = "scalar",
                 visible_radius: float = VISIBLE_RADIUS, device: Any = "cuda"):
        super().__init__(TAG_WALLS, time_limit, frame_skip, solver_iters,
                         integrator, ls_iters, pipeline, device)
        self.visible_radius = float(visible_radius)
        self._observation_space = Box(-np.inf, np.inf, (29,), dtype=torch.float32)

    # ------------------------------------------------ deterministic stages
    @staticmethod
    def spawn_target(agent_xy: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
        """The target's spawn from candidates ``[..., 257, 2]`` in draw
        order: the first at least ``MIN_SPAWN_DIST`` from ``agent_xy``, else
        the last.  The JAX package's rejection loop (a draw, then redraws
        while too near, at most 256) returns the same point from the same
        draws; the conditional distribution is uniform over the cage beyond
        the radius, short of the ≤ 0.9^256 ≈ 2e-12 chance that no
        candidate qualifies."""
        d = cands - agent_xy[..., None, :]
        ok = (d * d).sum(-1) >= MIN_SPAWN_DIST**2
        first = ok.to(torch.int32).argmax(-1)
        idx = torch.where(ok.any(-1), first, cands.shape[-2] - 1)
        return torch.gather(cands, -2, idx[..., None, None].expand(
            idx.shape + (1, 2)))[..., 0, :]

    def fresh(self, u_xy: torch.Tensor, u_cands: torch.Tensor) -> AntTagPhysicsState:
        """New episodes from uniforms in [0, 1): the ant's xy ``[B, 2]``
        and the target's candidates ``[B, 257, 2]``."""
        B = u_xy.shape[0]
        qpos = self.spawn_qpos(u_xy * (2 * CAGE) - CAGE)
        target = self.spawn_target(qpos[:, :2], u_cands * (2 * CAGE) - CAGE)
        zeros = qpos.new_zeros(B, _NV)
        return AntTagPhysicsState(
            elapsed=torch.zeros(B, dtype=torch.int32, device=qpos.device),
            qpos=qpos, qvel=zeros, warm=zeros.clone(), target_xy=target)

    def advance(self, state: AntTagPhysicsState, qpos, qvel, warm,
                mode: torch.Tensor):
        """The task after the physics: the target's flee by ``mode``, the
        tag test and the time limit → ``(mid_state, rew, done, trunc)``."""
        target = move_target(qpos[..., :2], state.target_xy, mode)
        d = qpos[..., :2] - target
        done = (d * d).sum(-1) <= TAG_RADIUS**2
        elapsed = state.elapsed + 1
        trunc = (elapsed >= self.time_limit) & ~done
        mid = AntTagPhysicsState(elapsed=elapsed, qpos=qpos, qvel=qvel,
                                 warm=warm, target_xy=target)
        return mid, done.to(torch.float32), done, trunc

    def observe(self, state: AntTagPhysicsState) -> torch.Tensor:
        d = state.qpos[..., :2] - state.target_xy
        visible = (d * d).sum(-1, keepdim=True) < self.visible_radius**2
        tail = torch.where(visible, state.target_xy, 0.0)
        return torch.cat([self._core_obs(state.qpos, state.qvel), tail], -1)

    # ------------------------------------------------------ batched fast path
    def _draw_fresh(self, generator: torch.Generator, num: int):
        u_xy = torch.rand((num, 2), generator=generator, device=self.device)
        u_cands = torch.rand((num, SPAWN_CANDIDATES, 2), generator=generator,
                             device=self.device)
        return self.fresh(u_xy, u_cands)

    def reset_vec(self, generator: torch.Generator, num_envs: int):
        state = self._draw_fresh(generator, num_envs)
        return self.observe(state), state

    def step_vec(self, generator: torch.Generator, state: AntTagPhysicsState,
                 action: torch.Tensor):
        """One step of B envs: the physics, the flee modes, the task, then
        the respawns (the JAX package's key order km, kr)."""
        B = action.shape[0]
        qpos, qvel, warm = self.physics(state.qpos, state.qvel, state.warm,
                                        action.reshape(B, 8))
        mode = torch.randint(0, 4, (B,), generator=generator,
                             device=self.device, dtype=torch.int32)
        mid, rew, done, trunc = self.advance(state, qpos, qvel, warm, mode)
        reset = done | trunc
        new_state = self.apply_reset(mid, reset, self._draw_fresh(generator, B))
        info = {"terminal_state": mid, "reset_mask": reset}
        return self.observe(new_state), new_state, rew, done, trunc, info


class AntHeavenHellPhysics(_AntPhysicsBase):
    """Articulated ant T-maze (the full reference env on the port's engine).
    ``device``: the card by default; pass ``"cpu"`` for the CPU."""

    name = "AntHeavenHellPhysics-v0"

    def __init__(self, time_limit: int = 500, frame_skip: int = 15,
                 solver_iters: int = 8, integrator: str = "rk4",
                 ls_iters: int = 10, pipeline: str = "scalar",
                 device: Any = "cuda"):
        super().__init__(HEAVEN_HELL_WALLS, time_limit, frame_skip,
                         solver_iters, integrator, ls_iters, pipeline, device)
        self._observation_space = Box(-np.inf, np.inf, (28,), dtype=torch.float32)
        self._sites = torch.as_tensor(HH_SITES, device=self.device)

    def observe(self, state: AntHeavenHellPhysicsState) -> torch.Tensor:
        d = state.qpos[..., :2] - self._sites[2].to(state.qpos.device)
        reveal = (d * d).sum(-1) <= HH_RADIUS**2
        one = torch.ones_like(d[..., 0])
        tail = torch.where(reveal, torch.where(state.heaven_right, one, -one), 0.0)
        return torch.cat([self._core_obs(state.qpos, state.qvel), tail[..., None]], -1)

    def task(self, qpos: torch.Tensor, heaven_right: torch.Tensor):
        """The JAX package's ``_task``: (done, rew) of arriving at heaven
        (+1) or hell (−1) within the radius."""
        d = qpos[..., None, :2] - self._sites.to(qpos.device)
        d2 = (d * d).sum(-1)                                   # [..., 3]
        reached = d2[..., :2] <= HH_RADIUS**2
        done = reached.any(-1)
        at_heaven = torch.where(heaven_right, reached[..., 1], reached[..., 0])
        one = torch.ones_like(d2[..., 0])
        rew = torch.where(done, torch.where(at_heaven, one, -one), 0.0)
        return done, rew

    def fresh(self, u_xy: torch.Tensor, heaven_right: torch.Tensor
              ) -> AntHeavenHellPhysicsState:
        """New episodes: the ant at uniforms ``u_xy [B, 2]`` mapped to
        x ∈ [-1, 1), y ∈ [0, 1) (reference ant_heaven_hell.py:50-75), the
        heaven side ``heaven_right [B]``."""
        B = u_xy.shape[0]
        qpos = self.spawn_qpos(torch.stack([u_xy[:, 0] * 2.0 - 1.0, u_xy[:, 1]], -1))
        zeros = qpos.new_zeros(B, _NV)
        return AntHeavenHellPhysicsState(
            elapsed=torch.zeros(B, dtype=torch.int32, device=qpos.device),
            qpos=qpos, qvel=zeros, warm=zeros.clone(), heaven_right=heaven_right)

    def advance(self, state: AntHeavenHellPhysicsState, qpos, qvel, warm):
        """The task after the physics → ``(mid_state, rew, done, trunc)``."""
        done, rew = self.task(qpos, state.heaven_right)
        elapsed = state.elapsed + 1
        trunc = (elapsed >= self.time_limit) & ~done
        mid = AntHeavenHellPhysicsState(elapsed=elapsed, qpos=qpos, qvel=qvel,
                                        warm=warm, heaven_right=state.heaven_right)
        return mid, rew, done, trunc

    def _draw_fresh(self, generator: torch.Generator, num: int):
        u_xy = torch.rand((num, 2), generator=generator, device=self.device)
        heaven = torch.rand(num, generator=generator, device=self.device) < 0.5
        return self.fresh(u_xy, heaven)

    def reset_vec(self, generator: torch.Generator, num_envs: int):
        state = self._draw_fresh(generator, num_envs)
        return self.observe(state), state

    def step_vec(self, generator: torch.Generator,
                 state: AntHeavenHellPhysicsState, action: torch.Tensor):
        B = action.shape[0]
        qpos, qvel, warm = self.physics(state.qpos, state.qvel, state.warm,
                                        action.reshape(B, 8))
        mid, rew, done, trunc = self.advance(state, qpos, qvel, warm)
        reset = done | trunc
        new_state = self.apply_reset(mid, reset, self._draw_fresh(generator, B))
        info = {"terminal_state": mid, "reset_mask": reset}
        return self.observe(new_state), new_state, rew, done, trunc, info
