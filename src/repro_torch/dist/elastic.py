"""Elastic rescaling: resume the newest checkpoint onto whatever devices
the current launch has, and re-split the global batch over the worker
count — port of ``repro/dist/elastic.py``.

The checkpoint format is topology-free (host numpy per leaf), so a run
killed on N devices restarts on M by restoring full tensors and placing
them by the new mesh's specs (``dist/sharding.place``).  Every resume
appends a record to ``scale_events.jsonl`` so rescale history is
auditable.
"""
from __future__ import annotations

import json
import os
import time

from repro_torch.dist import checkpoint


def elastic_batch(global_batch: int, n_workers: int) -> tuple[int, int]:
    """(per_worker, used_global): the largest even split not exceeding the
    requested global batch — never below 1 per worker, so a shrink-below-
    batch-size event rounds the effective batch UP to one per worker."""
    per = max(global_batch // n_workers, 1)
    return per, per * n_workers


def resume_elastic(ckpt_dir: str, template, mesh,
                   run_dir: str | None = None):
    """(step, state-or-None) from the newest checkpoint, logging the
    rescale event.  ``mesh`` is the CURRENT launch topology (a
    ``launch/mesh.Mesh``): the event records its size and axes.  The
    state comes back as full tensors on each template leaf's device, for
    the caller to place over ``mesh``; on a mesh of several processes
    only process 0 writes the event."""
    step, restored = checkpoint.restore_latest(ckpt_dir, template)
    event = {
        "time_unix": round(time.time(), 3),
        "step": step,
        "restored": restored is not None,
        "n_devices": int(mesh.size),
        "mesh_axes": dict(zip(mesh.axis_names, (int(s) for s in mesh.shape))),
    }
    if checkpoint._rank() == 0:
        log_dir = run_dir or ckpt_dir
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "scale_events.jsonl"), "a") as f:
            f.write(json.dumps(event) + "\n")
    return step, restored
