from .msrooms import MSRoomsState, MultistoryFourRooms
from .rocksample import RockSample, RockSampleState
from .rooms import Rooms, RoomsState
from .taxi import Taxi, TaxiState, TAXI_MAP, EXTENDED_TAXI_MAP

__all__ = ["Taxi", "TaxiState", "TAXI_MAP", "EXTENDED_TAXI_MAP", "Rooms",
           "RoomsState", "MultistoryFourRooms", "MSRoomsState", "RockSample",
           "RockSampleState"]
