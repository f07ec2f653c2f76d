"""The numbers that decide a training cell's ``correct``, from the
program's readings and the reference's.

Each is a widest gap: the loss's over the checked steps (absolute), and
over the leaves the gap between the program's norm and the reference's,
of the first gradient as the optimizer takes it and of the change over
the checked steps, each against the reference's norm of that leaf or of
the median leaf, whichever is larger.  A leaf whose reference gradient is
under a thousandth of the median leaf's moves by round-off alone and is
left out of the change.

The norms of a leaf average its elements' errors away in quadrature, so
:func:`sketch_gap` also compares the first gradient's direction: the
distance between the program's gradient and the reference's, relative to
the reference's, estimated from each leaf's projections on a few seeded
random directions (both sides project on the same ones, wherever their
shards lie), the median over the leaves.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict


# the numbers a training cell's ``correct`` compares; the loss's gap is
# read and reported beside them (see PERF.md for why it is not compared)
TRAIN_CHECKS = ("grad_gap", "grad_dir_gap", "change_gap")


def sketch_gap(prog: Dict, ref: Dict, keep) -> float:
    """The median over the kept leaves of the first gradient's distance
    from the reference's, relative to the reference's, as the leaf's
    random projections estimate it: |s_p - s_r| / |s_r| over the
    directions."""
    gaps = []
    for k in keep:
        a, b = prog["grad_sketch"][k], ref["grad_sketch"][k]
        num = sum((x - y) ** 2 for x, y in zip(a, b))
        den = sum(y * y for y in b)
        gaps.append(math.sqrt(num / max(den, 1e-300)))
    return statistics.median(gaps)


def train_gaps(prog: Dict, ref: Dict) -> Dict[str, float]:
    loss = max(abs(a - b) for a, b in zip(prog["loss"], ref["loss"]))
    gr = ref["grad_norm"]
    med = statistics.median(gr.values())
    grad = max(abs(prog["grad_norm"][k] - g) / max(g, med)
               for k, g in gr.items())
    keep = [k for k, g in gr.items() if g >= 1e-3 * med]
    cr = {k: ref["change_norm"][k] for k in keep}
    med_c = statistics.median(cr.values())
    change = max(abs(prog["change_norm"][k] - c) / max(c, med_c, 1e-30)
                 for k, c in cr.items())
    return {"loss_gap": loss, "grad_gap": grad, "change_gap": change,
            "grad_dir_gap": sketch_gap(prog, ref, keep)}
