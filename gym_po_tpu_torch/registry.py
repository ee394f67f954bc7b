"""Environment registry, PyTorch port of :mod:`gym_po_tpu.registry`.

Every id of the JAX package's registry: the Taxi family, ``Rooms-v0``,
``CRooms-v0``, ``MultistoryFourRooms-v0``, ``RockSample-v0``,
``TagContinuous-v0``, ``HeavenHellContinuous-v0``, ``CarFlag-v0``,
``DiscreteCarFlag-v0`` and the articulated ant's ``AntTagPhysics-v0`` and
``AntHeavenHellPhysics-v0``; ``make`` of any other id raises ``KeyError``
listing what is available.  Every constructor takes the JAX package's
kwargs plus ``device``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

__all__ = ["register", "make", "registered_envs"]

_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register(name: str, ctor: Callable[..., Any]) -> None:
    if name in _REGISTRY:
        raise ValueError(f"Environment {name!r} already registered")
    _REGISTRY[name] = ctor


def make(name: str, **overrides):
    """Construct a registered environment with kwarg overrides."""
    if name not in _REGISTRY:
        raise KeyError(
            f"Unknown environment {name!r}. Available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name](**overrides)


def registered_envs():
    return sorted(_REGISTRY)


def _register_defaults() -> None:
    from .envs.ant_physics import AntHeavenHellPhysics, AntTagPhysics
    from .envs.car_flag import CarFlag, DiscreteCarFlag
    from .envs.crooms import CRooms
    from .envs.msrooms import MultistoryFourRooms
    from .envs.rocksample import RockSample
    from .envs.rooms import Rooms
    from .envs.tag import HeavenHellContinuous, TagContinuous
    from .envs.taxi import Taxi, EXTENDED_TAXI_MAP

    register("Taxi-v4", lambda **kw: Taxi(**kw))
    register("HansenTaxi-v4", lambda **kw: Taxi(hansen_obs=True, **kw))
    register("ExtendedTaxi-v4", lambda **kw: Taxi(map=EXTENDED_TAXI_MAP, **kw))
    register(
        "ExtendedHansenTaxi-v4",
        lambda **kw: Taxi(map=EXTENDED_TAXI_MAP, hansen_obs=True, **kw),
    )
    register("Rooms-v0", lambda **kw: Rooms(**kw))
    register("CRooms-v0", lambda **kw: CRooms(**kw))
    register("MultistoryFourRooms-v0", lambda **kw: MultistoryFourRooms(**kw))
    register("RockSample-v0", lambda **kw: RockSample(**kw))
    register("TagContinuous-v0", lambda **kw: TagContinuous(**kw))
    register("HeavenHellContinuous-v0", lambda **kw: HeavenHellContinuous(**kw))
    register("CarFlag-v0", lambda **kw: CarFlag(**kw))
    register("DiscreteCarFlag-v0", lambda **kw: DiscreteCarFlag(**kw))
    register("AntTagPhysics-v0", lambda **kw: AntTagPhysics(**kw))
    register("AntHeavenHellPhysics-v0", lambda **kw: AntHeavenHellPhysics(**kw))


_register_defaults()
