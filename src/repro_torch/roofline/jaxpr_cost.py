"""FLOPs of one eager step (port of ``repro/roofline/jaxpr_cost.py``; the
file keeps the reference's name so a reader finds the counterpart).

The reference walks the jaxpr, because XLA's cost analysis counts a
scan's body once and its models scan over layer groups, KV chunks and
loss chunks.  The port runs eagerly, so it counts what runs:
:func:`step_flops` calls the step once under
``torch.utils.flop_counter.FlopCounterMode``, which counts matmuls,
batched matmuls and convolutions (2 x M x N x K, as the reference's
``dot_general`` rule does).

* Every loop trip runs, so no trip-count correction is needed.
* Each ``torch.utils.checkpoint`` recompute counts where it runs, in the
  backward pass, as the reference counts a remat body at every call
  site.  A non-reentrant checkpoint stops recomputing once the backward
  has every tensor it saved, so a body's last ops may not rerun: what is
  counted is what ran.

The reference's jaxpr walker (``jaxpr_flops`` and its per-primitive
rules) has no counterpart: there is no jaxpr to walk.
"""
from __future__ import annotations

from torch.utils.flop_counter import FlopCounterMode


def step_flops(fn, *args) -> float:
    """Global FLOPs of ``fn(*args)``, run once."""
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())
