"""Median time to first token over every request finished in the
window, ms: from the batch's lookup until the request's first token is
on the host (the loop is closed, so a batch waits in no queue)."""
import numpy as np


def read(run):
    ttft = [b.first_token - b.start for b in run.batches for _ in range(b.rows)]
    return float(np.percentile(ttft, 50)) * 1e3 if ttft else None
