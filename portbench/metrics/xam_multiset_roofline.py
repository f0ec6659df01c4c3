"""The multi-set CAM search kernel's share of its roofline, %: the
least time for the bytes the window's searches need (``count/bytes.py``:
each searched set's planes, each key and each answer once; over the
3.35 TB/s of HBM) over the kernel's device time in the traced window.
Nothing to read where the profiler saw no such kernel."""
import numpy as np

from portbench.count import bytes as nbytes, peaks
from portbench.reference.index import fingerprints, murmur3

KERNEL = "xam_multiset"


def read(run):
    tl = run.timeline
    if tl is None:
        return None
    kernel_s = sum(v for k, v in tl.by_op.items() if KERNEL in k)
    if kernel_s <= 0:
        return None
    geo = run.cell.config["index"]
    need = 0
    for toks in run.lookups:
        fp = fingerprints(toks, geo["fingerprint"]).reshape(-1)
        sets = np.unique(murmur3(fp) % np.uint32(geo["n_sets"])).size
        need += nbytes.multiset_search_bytes(geo, fp.size, sets)
    return 100.0 * need / peaks.HBM_BYTES / kernel_s
