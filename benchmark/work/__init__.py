"""Bytes each query kind needs, whatever implements it."""
