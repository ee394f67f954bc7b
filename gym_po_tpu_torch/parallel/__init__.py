from .data_parallel import chunk_seeds

__all__ = ["chunk_seeds"]
