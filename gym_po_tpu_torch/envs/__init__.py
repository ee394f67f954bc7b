from .taxi import Taxi, TaxiState, TAXI_MAP, EXTENDED_TAXI_MAP

__all__ = ["Taxi", "TaxiState", "TAXI_MAP", "EXTENDED_TAXI_MAP"]
