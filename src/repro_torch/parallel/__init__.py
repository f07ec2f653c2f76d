"""Parallelism pieces of the port: the logical-axis sharding rules as
``DeviceMesh`` placements, the COMET collective planner with the
explicit-collective softmax loss, and int8 gradient compression with its
all-reduce."""
from . import collective_planner, compression, sharding

__all__ = ["collective_planner", "compression", "sharding"]
