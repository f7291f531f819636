"""The plain reference the benchmark judges the program's outputs by."""
from .model import Reference, capacity_keep, route_gaps, served_gaps

__all__ = ["Reference", "capacity_keep", "route_gaps", "served_gaps"]
