from .ant_physics import (AntHeavenHellPhysics, AntHeavenHellPhysicsState,
                          AntTagPhysics, AntTagPhysicsState)
from .car_flag import CarFlag, CarFlagState, DiscreteCarFlag
from .crooms import CRooms, CRoomsState
from .msrooms import MSRoomsState, MultistoryFourRooms
from .rocksample import RockSample, RockSampleState
from .rooms import Rooms, RoomsState
from .shaping import PotentialShaped, heaven_hell_potential, tag_potential
from .tag import (HeavenHellContinuous, HeavenHellState, TagContinuous,
                  TagState)
from .taxi import Taxi, TaxiState, TAXI_MAP, EXTENDED_TAXI_MAP

__all__ = ["Taxi", "TaxiState", "TAXI_MAP", "EXTENDED_TAXI_MAP", "Rooms",
           "RoomsState", "MultistoryFourRooms", "MSRoomsState", "RockSample",
           "RockSampleState", "CRooms", "CRoomsState", "TagContinuous",
           "TagState", "HeavenHellContinuous", "HeavenHellState", "CarFlag",
           "DiscreteCarFlag", "CarFlagState", "PotentialShaped",
           "heaven_hell_potential", "tag_potential", "AntTagPhysics",
           "AntTagPhysicsState", "AntHeavenHellPhysics",
           "AntHeavenHellPhysicsState"]
