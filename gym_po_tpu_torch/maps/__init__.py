from .layouts import LAYOUT_NAMES, layout_end, layout_grid, layout_start
from .taxi_maps import TAXI_MAP, EXTENDED_TAXI_MAP, TaxiTables, compile_taxi_map

__all__ = ["TAXI_MAP", "EXTENDED_TAXI_MAP", "TaxiTables", "compile_taxi_map",
           "LAYOUT_NAMES", "layout_grid", "layout_start", "layout_end"]
