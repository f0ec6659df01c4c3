"""Index lookup a batch, ms: the host clock around the program's
``AdmitQueue.lookup`` (fingerprints, grouping by set, the multi-set
search, its answer on the host; ending in a device synchronisation),
summed over the window over its batches."""


def read(run):
    n = len(run.batches)
    return sum(b.lookup_s for b in run.batches) / n * 1e3 if n else None
