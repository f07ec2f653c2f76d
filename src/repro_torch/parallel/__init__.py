"""Parallelism pieces of the port.  ``compression`` only: the sharding
rules, the collective planner and the int8 all-reduce need a process group
and a mesh, which the port does not have yet."""
from . import compression

__all__ = ["compression"]
