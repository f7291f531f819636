"""The plain reference the benchmark judges the program's outputs by: each
kind's ``Reference`` in ``chipbench/kinds/<kind>.py``; ``Reference`` and
``capacity_keep`` here are the ``gqa`` kind's."""
from ..kinds.gqa import Reference, capacity_keep
from .model import served_gaps

__all__ = ["Reference", "capacity_keep", "served_gaps"]
