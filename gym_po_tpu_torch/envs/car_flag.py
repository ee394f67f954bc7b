"""CarFlag-v0 and DiscreteCarFlag-v0, the heaven/hell car: PyTorch port of
:mod:`gym_po_tpu.envs.car_flag`.

1-D continuous control (reference ``gym_po/envs/car_flag.py:23-303``): a
car must visit the priest region (|pos - priest| <= 0.2) to observe which
end is heaven (+1 reward) and which is hell (-1 reward).  Kept from the
reference, as the JAX package keeps them:

* the velocity is zeroed only at the left edge (``pos == MIN_POS`` and
  ``vel < 0``);
* truncation at ``elapsed >= time_limit`` (the other envs use ``>``);
* the priest-window test happens in the priest's dtype, and the discrete
  wrapper's ``linspace`` force in its own: with ``parity=True`` the
  priests and the discrete forces are float64, so the physics promotes to
  float64 before the float32 state store as NumPy's does (the JAX
  package's parity mode under ``jax_enable_x64``).  The default keeps
  float32 throughout.

The dynamics are deterministic stages (``advance``, ``apply_reset``,
``observe``) that take the force and the reset draws as arguments;
``step_vec`` composes them with draws from an explicit ``torch.Generator``.
No kernel: the step is a few elementwise operations.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from ..core import Box, Discrete, Environment, EnvState
from ..core.env import _stack, _unstack

__all__ = ["CarFlag", "DiscreteCarFlag", "CarFlagState"]

MAX_POS = 1.1
MIN_POS = -MAX_POS
MAX_SPEED = 0.07
MIN_ACT = -1.0
MAX_ACT = 1.0
PRIEST = 0.5
PRIEST_THRESHOLD = 0.2
POWER = 0.0015


@dataclasses.dataclass(frozen=True)
class CarFlagState(EnvState):
    pos: torch.Tensor  # f32 [...]
    vel: torch.Tensor  # f32 [...]
    dirn: torch.Tensor  # f32 [...]: heaven's side if within the priest window
    heaven: torch.Tensor  # f32 [...] in {-1, +1}
    priest: torch.Tensor  # [...] in {-0.5, +0.5}; float64 in parity mode


class CarFlag(Environment[CarFlagState]):
    """Continuous-control heaven/hell car (reference car_flag.py:23-283).
    ``device``: the card by default; pass ``"cpu"`` for the CPU."""

    def __init__(self, time_limit: int = 160, parity: bool = False,
                 device: Any = "cuda"):
        self.name = "CarFlag-v0"
        self.time_limit = int(time_limit)
        self.parity = bool(parity)
        self.device = torch.device(device)
        self._observation_space = Box(
            np.array([MIN_POS, -MAX_SPEED, -1.0], np.float32),
            np.array([MAX_POS, MAX_SPEED, 1.0], np.float32),
            (3,),
            dtype=torch.float32,
        )
        self._action_space = Box(MIN_ACT, MAX_ACT, (1,), dtype=torch.float32)

    @property
    def observation_space(self) -> Box:
        return self._observation_space

    @property
    def action_space(self):
        return self._action_space

    # ------------------------------------------------ deterministic stages
    def advance(self, state: CarFlagState, force: torch.Tensor):
        """One physics step (reference car_flag.py:114-139).

        ``force`` is the clipped control; its dtype and the priest's drive
        the promotion.  Returns ``(mid_state, reward, done, truncated)``.
        """
        elapsed = state.elapsed + 1
        nv = torch.clamp(state.vel + force * POWER, -MAX_SPEED, MAX_SPEED)
        npos = torch.clamp(state.pos + nv, MIN_POS, MAX_POS)
        nv = torch.where((npos == MIN_POS) & (nv < 0), torch.zeros_like(nv), nv)
        done = torch.abs(npos) >= 1.0
        hh = torch.sign(npos)
        one = torch.ones_like(state.pos)
        rew = torch.where(done & (hh == state.heaven), one,
                          torch.where(done & (hh == -state.heaven), -one, 0.0))
        trunc = elapsed >= self.time_limit  # >= here, > elsewhere
        in_window = (npos >= state.priest - PRIEST_THRESHOLD) & (
            npos <= state.priest + PRIEST_THRESHOLD)
        dirn = torch.where(in_window, state.heaven, 0.0)
        mid = state.replace(pos=npos.to(torch.float32), vel=nv.to(torch.float32),
                            dirn=dirn.to(torch.float32), elapsed=elapsed)
        return mid, rew, done, trunc

    def apply_reset(self, state: CarFlagState, mask: torch.Tensor,
                    pos_new: torch.Tensor, heaven_new: torch.Tensor,
                    priest_new: torch.Tensor) -> CarFlagState:
        """Masked partial reset (reference car_flag.py:97-110)."""
        return state.replace(
            pos=torch.where(mask, pos_new.to(torch.float32), state.pos),
            vel=torch.where(mask, 0.0, state.vel),
            dirn=torch.where(mask, 0.0, state.dirn),
            heaven=torch.where(mask, heaven_new.to(torch.float32), state.heaven),
            priest=torch.where(mask, priest_new.to(state.priest.dtype),
                               state.priest),
            elapsed=torch.where(mask, 0, state.elapsed),
        )

    def observe(self, state: CarFlagState) -> torch.Tensor:
        return torch.stack([state.pos, state.vel, state.dirn], -1)

    def observe_vec(self, state: CarFlagState) -> torch.Tensor:
        return self.observe(state)  # written over any leading axes

    def _force(self, action: torch.Tensor) -> torch.Tensor:
        """Continuous control ``[B, 1]``: clip to [-1, 1] (reference
        :116-117)."""
        return torch.clamp(action.reshape(action.shape[0]), MIN_ACT, MAX_ACT)

    # ------------------------------------------------------- random sampling
    def _sample_reset_vec(self, generator: torch.Generator, num: int):
        """pos ~ U(-0.2, 0.2); heaven, priest ~ fair coins (reference
        :100-110)."""
        dev = self.device

        def sign():
            coin = torch.rand(num, generator=generator, device=dev) < 0.5
            return torch.where(coin, 1.0, -1.0)

        pos = torch.rand(num, generator=generator, device=dev) * 0.4 - 0.2
        heaven = sign()
        priest = sign() * PRIEST
        return pos, heaven, priest.to(torch.float64 if self.parity else torch.float32)

    def sample_reset(self, generator: torch.Generator):
        pos, heaven, priest = self._sample_reset_vec(generator, 1)
        return pos[0], heaven[0], priest[0]

    # -------------------------------------------------------------- protocol
    def reset_env(self, generator: torch.Generator) -> Tuple[torch.Tensor, CarFlagState]:
        obs, state = self.reset_vec(generator, 1)
        return obs[0], _unstack(state, 0)

    def step_env(self, generator: torch.Generator, state: CarFlagState,
                 action: torch.Tensor):
        obs, st, rew, done, trunc, info = self.step_vec(
            generator, _stack([state]), action.reshape(1, -1))
        info = {"terminal_state": _unstack(info["terminal_state"], 0),
                "reset_mask": info["reset_mask"][0]}
        return obs[0], _unstack(st, 0), rew[0], done[0], trunc[0], info

    # ------------------------------------------------------ batched fast path
    def reset_vec(self, generator: torch.Generator, num_envs: int):
        pos, heaven, priest = self._sample_reset_vec(generator, num_envs)
        zeros = torch.zeros(num_envs, dtype=torch.float32, device=self.device)
        state = CarFlagState(
            elapsed=torch.zeros(num_envs, dtype=torch.int32, device=self.device),
            pos=pos, vel=zeros, dirn=zeros, heaven=heaven, priest=priest)
        return self.observe(state), state

    def step_vec(self, generator: torch.Generator, state: CarFlagState,
                 action: torch.Tensor):
        mid, rew, done, trunc = self.advance(state, self._force(action))
        reset = done | trunc
        new_state = self.apply_reset(
            mid, reset, *self._sample_reset_vec(generator, action.shape[0]))
        info = {"terminal_state": mid, "reset_mask": reset}
        return self.observe(new_state), new_state, rew, done, trunc, info


class DiscreteCarFlag(CarFlag):
    """Evenly spaced discrete forces (reference car_flag.py:286-303): action
    ``a`` pushes with ``linspace(-1, 1, num_actions)[a]``, float64 in parity
    mode."""

    def __init__(self, num_actions: int = 3, time_limit: int = 160,
                 parity: bool = False, device: Any = "cuda"):
        super().__init__(time_limit=time_limit, parity=parity, device=device)
        self.name = "DiscreteCarFlag-v0"
        self.num_actions = int(num_actions)
        self.forces_np = np.linspace(MIN_ACT, MAX_ACT, num_actions)
        self._forces = torch.as_tensor(
            self.forces_np, dtype=torch.float64 if parity else torch.float32,
            device=self.device)
        self._action_space = Discrete(self.num_actions)

    def _force(self, action: torch.Tensor) -> torch.Tensor:
        return torch.clamp(self._forces[action.reshape(action.shape[0]).long()],
                           MIN_ACT, MAX_ACT)
