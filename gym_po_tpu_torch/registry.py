"""Environment registry, PyTorch port of :mod:`gym_po_tpu.registry`.

Only the Taxi family is ported so far; ``make`` of any other id raises
``KeyError`` listing what is available.  Every constructor takes the
JAX package's kwargs plus ``device``.
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
    from .envs.taxi import Taxi, EXTENDED_TAXI_MAP

    register("Taxi-v4", lambda **kw: Taxi(**kw))
    register("HansenTaxi-v4", lambda **kw: Taxi(hansen_obs=True, **kw))
    register("ExtendedTaxi-v4", lambda **kw: Taxi(map=EXTENDED_TAXI_MAP, **kw))
    register(
        "ExtendedHansenTaxi-v4",
        lambda **kw: Taxi(map=EXTENDED_TAXI_MAP, hansen_obs=True, **kw),
    )


_register_defaults()
