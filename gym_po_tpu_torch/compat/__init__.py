"""The gymnasium vector API over the port's envs (imports gymnasium)."""

from .gym_api import (
    CarVecEnv,
    CRoomsEnv,
    DiscreteActionCarVecEnv,
    ExtendedHansenTaxiVecEnv,
    ExtendedTaxiVecEnv,
    GymnasiumVecAdapter,
    HansenTaxiVecEnv,
    MultistoryFourRoomsEnv,
    RoomsEnv,
    TaxiVecEnv,
)

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
