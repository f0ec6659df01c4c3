"""Bytes the multi-set CAM search needs, from the index geometry and the
queries alone, whatever kernel runs it: each searched set's stored-bit
plane and validity plane read once, each query's key (``key_bits / 8``
bytes) read once, each answer (a 4-byte way) written once."""
from __future__ import annotations


def plane_bytes_per_set(geometry: dict) -> int:
    """Stored bits (one byte a bit under ``int8``, a bit a bit under
    ``packed8``) plus one validity byte a way."""
    rows = geometry["key_bits"] if geometry["plane_format"] == "int8" \
        else geometry["key_bits"] // 8
    return rows * geometry["set_ways"] + geometry["set_ways"]


def multiset_search_bytes(geometry: dict, n_queries: int,
                          searched_sets: int) -> int:
    """Bytes of one search of ``n_queries`` keys over ``searched_sets``
    distinct sets."""
    return (searched_sets * plane_bytes_per_set(geometry)
            + n_queries * (geometry["key_bits"] // 8 + 4))
