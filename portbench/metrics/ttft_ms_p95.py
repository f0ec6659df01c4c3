"""95th percentile of the time to first token over every request
finished in the window (not over batches), ms."""
import numpy as np


def read(run):
    ttft = [b.first_token - b.start for b in run.batches for _ in range(b.rows)]
    return float(np.percentile(ttft, 95)) * 1e3 if ttft else None
