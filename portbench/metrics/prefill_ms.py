"""Prefill a batch, ms: the host clock around the program's prefill
(``transformer.prefill``, through ``PrefixResumeEngine.prefill`` where it
resumes) until the first tokens are on the host, summed over the window
over its batches."""


def read(run):
    n = len(run.batches)
    return sum(b.prefill_s for b in run.batches) / n * 1e3 if n else None
