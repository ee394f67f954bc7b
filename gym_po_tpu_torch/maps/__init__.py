from .taxi_maps import TAXI_MAP, EXTENDED_TAXI_MAP, TaxiTables, compile_taxi_map

__all__ = ["TAXI_MAP", "EXTENDED_TAXI_MAP", "TaxiTables", "compile_taxi_map"]
