"""Elastic scaling and straggler mitigation.

Port of ``repro/train/elastic.py``:

* :func:`remesh` — reshard a live tree (or a restored checkpoint) onto a
  new mesh: the recovery path after losing (or gaining) data-parallel
  replicas.  With ``checkpoint.restore_checkpoint(shardings=, mesh=)``
  this gives checkpoint-elastic restarts.
* :class:`StragglerMonitor` — per-step wall-time EMA; flags steps slower
  than ``threshold``x the EMA (the training driver can then skip the
  all-reduce for that replica or re-dispatch data, and the monitor records
  the event for the ops log).
* :func:`shrink_mesh` — drop failed ranks and rebuild the largest
  rectangular ``(data, model)`` mesh that still fits.

Process groups are made by every rank of the world in the same order,
kept or not (``torch.distributed.new_group``'s rule): call
:func:`shrink_mesh` on every rank.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

import torch.distributed as dist

from ..models.param import tree_map, tree_zip
from ..parallel.collective_planner import make_submesh
from ..parallel.sharding import gather_leaf, shard_leaf

__all__ = ["remesh", "shrink_mesh", "StragglerMonitor"]


def remesh(tree, placements: Callable[[Any], Any], old_mesh, new_mesh
           ) -> Any:
    """Move a tree of this rank's shards on ``old_mesh`` onto ``new_mesh``
    (any shape or size): each leaf in turn gathered whole over
    ``old_mesh`` (every rank of it calls) and cut to this rank's shard
    under the new mesh's placements, so that a rank holds one whole leaf
    at a time.  ``placements(mesh)`` gives the tree of placements on a
    mesh (e.g. ``lambda m: sharding.param_shardings(specs, m)``).  Every
    rank of ``new_mesh`` must be on ``old_mesh`` (to grow, restore from a
    checkpoint); a rank outside ``new_mesh`` gets None."""
    keep = new_mesh.get_coordinate() is not None
    trips = iter(tree_zip(tree, placements(old_mesh), placements(new_mesh)))

    def one(_):
        t, old, new = next(trips)
        whole = gather_leaf(t, old, old_mesh)
        return shard_leaf(whole, new, new_mesh) if keep else None
    moved = tree_map(one, tree)
    return moved if keep else None


def shrink_mesh(failed_devices: int, *, model_parallel: int,
                ranks: Optional[Sequence[int]] = None, device=None):
    """Rebuild a ``(data, model)`` mesh after losing ``failed_devices``:
    the model-parallel width is kept (TP shards do not divide further);
    whole data-parallel replicas are dropped, the first ones of ``ranks``
    (default: the world's) kept.  Every rank of the world calls it."""
    ranks = list(ranks if ranks is not None
                 else range(dist.get_world_size()))
    usable = len(ranks) - failed_devices
    data = usable // model_parallel
    if data < 1:
        raise RuntimeError(
            f"cannot keep model_parallel={model_parallel} with "
            f"{usable} devices")
    return make_submesh(ranks[: data * model_parallel],
                        (data, model_parallel), ("data", "model"), device)


@dataclass
class StragglerMonitor:
    threshold: float = 2.0
    decay: float = 0.9
    ema: Optional[float] = None
    events: List[dict] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self, step: int) -> bool:
        """Returns True if this step was a straggler."""
        dt = time.monotonic() - (self._t0 or time.monotonic())
        is_straggler = self.ema is not None and dt > self.threshold * self.ema
        if is_straggler:
            self.events.append({"step": step, "duration_s": dt,
                                "ema_s": self.ema})
        # EMA excludes straggler steps (they would poison the baseline)
        if not is_straggler:
            self.ema = dt if self.ema is None else \
                self.decay * self.ema + (1 - self.decay) * dt
        return is_straggler
