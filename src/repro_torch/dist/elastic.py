"""Elastic rescaling: resume the newest checkpoint onto whatever devices
the current launch has, and re-split the global batch over the worker
count — port of ``repro/dist/elastic.py``.

The checkpoint format is topology-free (host numpy per leaf), so a run
killed on N devices restarts on M by restoring onto the new launch's
device.  Every resume appends a record to ``scale_events.jsonl`` so
rescale history is auditable.
"""
from __future__ import annotations

import json
import os
import time

import torch

from repro_torch.dist import checkpoint


def elastic_batch(global_batch: int, n_workers: int) -> tuple[int, int]:
    """(per_worker, used_global): the largest even split not exceeding the
    requested global batch — never below 1 per worker, so a shrink-below-
    batch-size event rounds the effective batch UP to one per worker."""
    per = max(global_batch // n_workers, 1)
    return per, per * n_workers


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def resume_elastic(ckpt_dir: str, template, device=None,
                   run_dir: str | None = None):
    """(step, state-or-None) from the newest checkpoint, restored onto
    ``device`` (each template leaf's own device when None), logging the
    rescale event.  The event's ``n_devices`` is the ``torch.distributed``
    world size (1 without an initialised group) and its ``mesh_axes`` is
    ``{"data": n_devices}``: the port's launches are data-parallel only."""
    step, restored = checkpoint.restore_latest(ckpt_dir, template, device)
    n = _world_size()
    event = {
        "time_unix": round(time.time(), 3),
        "step": step,
        "restored": restored is not None,
        "n_devices": n,
        "mesh_axes": {"data": n},
    }
    log_dir = run_dir or ckpt_dir
    os.makedirs(log_dir, exist_ok=True)
    with open(os.path.join(log_dir, "scale_events.jsonl"), "a") as f:
        f.write(json.dumps(event) + "\n")
    return step, restored
