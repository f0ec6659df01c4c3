"""``launch/httpd.py`` whose process 1 answers the first chunk of every
lookup wrongly (helper of tests/test_torch_mesh_launch.py; not collected;
imports no JAX).

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 tests/_torch_httpd_diverged.py --mesh host \
        --arch yi-9b --reduced --device cpu --port 0
"""
from __future__ import annotations

import os
import sys

import numpy as np

from repro_torch.launch import httpd
from repro_torch.serve.admit_queue import AdmitQueue

if __name__ == "__main__":
    if os.environ.get("RANK") == "1":
        lookup = AdmitQueue.lookup

        def skewed(self, tokens):
            hits = np.array(lookup(self, tokens))
            hits[0, 0] = not hits[0, 0]
            return hits
        AdmitQueue.lookup = skewed
    httpd.main(sys.argv[1:])
