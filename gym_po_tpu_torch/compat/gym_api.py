"""The gymnasium vector API over the port's envs, PyTorch port of
:mod:`gym_po_tpu.compat.gym_api`.

A user of the reference (``gym_po``) drives stateful vec envs:

    env = TaxiVecEnv(num_envs=256, hansen_obs=True)
    obs, info = env.reset(seed=0)
    obs, rew, done, trunc, info = env.step(actions)

The classes keep the reference's names, constructor signatures and quirks,
plus ``device`` (the card by default; ``"cpu"`` for the CPU): the adapter
holds the env, a ``torch.Generator`` on its device (seeded by
``reset(seed=...)``) and the batched state, takes NumPy actions and returns
NumPy arrays.  The dynamics are the port's perf-mode ones (its own
randomness), as the JAX adapter's are JAX's.

Kept quirks of the reference:

* ``RoomsEnv.reset`` / ``CRoomsEnv.reset`` return the bare obs with no info
  dict (reference ``rooms.py:177-189``, ``crooms.py:251-266``); Taxi,
  MultistoryFourRooms and Car return ``(obs, {})``, as the JAX adapter's;
* ``CRoomsEnv`` has ``seed()`` (reference ``crooms.py:246-249``);
* ``step`` returns an empty info dict unless ``info_mode="full"``.

Only this module of the port imports gymnasium.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Sequence

import gymnasium
import numpy as np
import torch

from ..core import Environment, map_tensors
from ..envs.car_flag import CarFlag, DiscreteCarFlag
from ..envs.crooms import CRooms
from ..envs.msrooms import MultistoryFourRooms
from ..envs.rooms import Rooms
from ..envs.taxi import EXTENDED_TAXI_MAP, TAXI_MAP, Taxi

__all__ = [
    "GymnasiumVecAdapter",
    "TaxiVecEnv",
    "HansenTaxiVecEnv",
    "ExtendedTaxiVecEnv",
    "ExtendedHansenTaxiVecEnv",
    "RoomsEnv",
    "CRoomsEnv",
    "MultistoryFourRoomsEnv",
    "CarVecEnv",
    "DiscreteActionCarVecEnv",
]


def _numpy(tree):
    return map_tensors(lambda t: t.cpu().numpy(), tree)


class GymnasiumVecAdapter(gymnasium.Env):
    """Stateful gymnasium-style vec-env view of an env of the port.

    Subclasses ``gymnasium.Env`` like the reference's vec envs (reference
    ``extended_taxi.py:149``), so isinstance checks and gymnasium wrappers
    work on it.
    """

    metadata = {"render_modes": ["rgb_array", "human"], "render_fps": 5}

    #: subclasses set True to keep the reference's bare-obs reset
    _bare_reset = False

    def __init__(self, env: Environment, num_envs: int,
                 render_mode: Optional[str] = None, info_mode: str = "reference"):
        if info_mode not in ("reference", "full"):
            raise ValueError(
                f"info_mode must be 'reference' or 'full', got {info_mode!r}")
        self.env = env
        self.num_envs = int(num_envs)
        self.is_vector_env = True
        self.render_mode = render_mode
        self.info_mode = info_mode
        self._window = None

        self.single_observation_space = env.observation_space.to_gymnasium()
        self.single_action_space = env.action_space.to_gymnasium()
        import gymnasium.vector.utils as gvu

        self.observation_space = gvu.batch_space(self.single_observation_space,
                                                 self.num_envs)
        self.action_space = gvu.batch_space(self.single_action_space,
                                            self.num_envs)
        self._generator = torch.Generator(device=env.device).manual_seed(0)
        self._state = None

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._generator.manual_seed(seed)
        obs, self._state = self.env.reset_vec(self._generator, self.num_envs)
        obs = obs.cpu().numpy()
        return obs if self._bare_reset else (obs, {})

    def step(self, actions):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        a = torch.as_tensor(np.asarray(actions)).to(
            self.env.device, self.env.action_space.dtype)
        obs, self._state, rew, done, trunc, info = self.env.step_vec(
            self._generator, self._state, a)
        # the reference's vec envs return an empty info dict
        # (extended_taxi.py:287); "full" passes the env's info through
        # (``terminal_state``, and episode statistics under
        # :class:`~gym_po_tpu_torch.vector.RecordEpisodeStatistics`)
        out_info = _numpy(dict(info)) if self.info_mode == "full" else {}
        return (obs.cpu().numpy(), rew.cpu().numpy(), done.cpu().numpy(),
                trunc.cpu().numpy(), out_info)

    def render(self, idx: Optional[Sequence[int]] = None):
        from ..render import human_view, render

        img = render(self.env, self._state, idx)
        if self.render_mode == "human":
            self._window = human_view(img, self._window)
        return img

    def close(self):
        if self._window is not None:  # pragma: no cover
            import pygame

            pygame.quit()
            self._window = None

    @property
    def state(self):
        """The batched env state (for checkpointing and rendering)."""
        return self._state

    def __repr__(self):  # pragma: no cover
        return f"{type(self).__name__}(num_envs={self.num_envs})"


class TaxiVecEnv(GymnasiumVecAdapter):
    """Reference ``TaxiVecEnv`` surface (extended_taxi.py:149-230)."""

    metadata = {"render_modes": ["rgb_array", "human"], "render_fps": 5,
                "name": "Taxi"}
    ACTIONS_YX = np.array([[-1, 0], [1, 0], [0, -1], [0, 1], [0, 0]], int)
    ACTION_NAMES = ["North", "South", "West", "East", "Pickup/Dropoff"]
    ACTION_DICT = {i: n for i, n in enumerate(ACTION_NAMES)}

    def __init__(self, num_envs: int = 1, time_limit: int = 200,
                 num_passengers: int = 1, map: Sequence[str] = TAXI_MAP,
                 hansen_obs: bool = False, reward_goal: float = 1.0,
                 reward_bad: float = -0.5, reward_any: float = -0.05,
                 render_mode: Optional[str] = None, info_mode: str = "reference",
                 device: Any = "cuda"):
        super().__init__(
            Taxi(map=map, hansen_obs=hansen_obs, num_passengers=num_passengers,
                 time_limit=time_limit, reward_goal=reward_goal,
                 reward_bad=reward_bad, reward_any=reward_any, device=device),
            num_envs, render_mode, info_mode)


HansenTaxiVecEnv = functools.partial(TaxiVecEnv, hansen_obs=True)
ExtendedTaxiVecEnv = functools.partial(TaxiVecEnv, map=EXTENDED_TAXI_MAP)
ExtendedHansenTaxiVecEnv = functools.partial(TaxiVecEnv, map=EXTENDED_TAXI_MAP,
                                             hansen_obs=True)


class RoomsEnv(GymnasiumVecAdapter):
    """Reference ``RoomsEnv`` surface (rooms.py:71-226)."""

    _bare_reset = True

    def __init__(self, num_envs: int, render_mode: Optional[str] = None,
                 info_mode: str = "reference", device: Any = "cuda", **kw):
        super().__init__(Rooms(device=device, **kw), num_envs, render_mode,
                         info_mode)


class CRoomsEnv(GymnasiumVecAdapter):
    """Reference ``CRoomsEnv`` surface (crooms.py:91-338)."""

    _bare_reset = True

    def __init__(self, num_envs: int, render_mode: Optional[str] = None,
                 info_mode: str = "reference", device: Any = "cuda", **kw):
        super().__init__(CRooms(device=device, **kw), num_envs, render_mode,
                         info_mode)

    def seed(self, seed: Optional[int] = None):
        """Reference crooms.py:246-249: reseed the private stream."""
        if seed is not None:
            self._generator.manual_seed(seed)


class MultistoryFourRoomsEnv(GymnasiumVecAdapter):
    """Reference ``MultistoryFourRoomsEnv`` surface (msrooms.py:257-433).

    Its reset returns ``(obs, {})``, as the JAX adapter's does (the JAX
    module's docstring lists it with the bare-obs resets; its code and
    tests do not)."""

    def __init__(self, num_envs: int, render_mode: Optional[str] = None,
                 info_mode: str = "reference", device: Any = "cuda", **kw):
        super().__init__(MultistoryFourRooms(device=device, **kw), num_envs,
                         render_mode, info_mode)


class CarVecEnv(GymnasiumVecAdapter):
    """Reference ``CarVecEnv`` surface (car_flag.py:23-283)."""

    def __init__(self, num_envs: int, time_limit: int = 160,
                 render_mode: Optional[str] = None, info_mode: str = "reference",
                 device: Any = "cuda"):
        super().__init__(CarFlag(time_limit=time_limit, device=device), num_envs,
                         render_mode, info_mode)


class DiscreteActionCarVecEnv(GymnasiumVecAdapter):
    """Reference ``DiscreteActionCarVecEnv`` surface (car_flag.py:286-303)."""

    def __init__(self, num_actions: int, num_envs: int, time_limit: int = 160,
                 render_mode: Optional[str] = None, info_mode: str = "reference",
                 device: Any = "cuda"):
        super().__init__(
            DiscreteCarFlag(num_actions=num_actions, time_limit=time_limit,
                            device=device),
            num_envs, render_mode, info_mode)
        nact = num_actions // 2
        self.action_names = ["<" * i + ":" for i in reversed(range(1, nact + 1))] + [
            ":" + ">" * i for i in range(1, nact + 1)]
        if num_actions % 2 == 1:
            self.action_names.insert(nact, ":")
