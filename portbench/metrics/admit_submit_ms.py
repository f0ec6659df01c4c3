"""Admission submit a batch, ms: the host clock around the program's
``AdmitQueue.submit_tokens`` (fingerprints, staging the new KV slabs,
the enqueue; it blocks only at a pending bound), summed over the window
over its batches."""


def read(run):
    n = len(run.batches)
    return sum(b.submit_s for b in run.batches) / n * 1e3 if n else None
