from .crooms import CRooms, CRoomsState
from .msrooms import MSRoomsState, MultistoryFourRooms
from .rocksample import RockSample, RockSampleState
from .rooms import Rooms, RoomsState
from .tag import (HeavenHellContinuous, HeavenHellState, TagContinuous,
                  TagState)
from .taxi import Taxi, TaxiState, TAXI_MAP, EXTENDED_TAXI_MAP

__all__ = ["Taxi", "TaxiState", "TAXI_MAP", "EXTENDED_TAXI_MAP", "Rooms",
           "RoomsState", "MultistoryFourRooms", "MSRoomsState", "RockSample",
           "RockSampleState", "CRooms", "CRoomsState", "TagContinuous",
           "TagState", "HeavenHellContinuous", "HeavenHellState"]
