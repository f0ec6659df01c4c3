"""Shared fixtures of the benchmark's own tests (CPU; a test marked
``gpu`` decides inside its fixture whether a card is there)."""
from __future__ import annotations

import pathlib
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
for p in (str(HERE), str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def card():
    """Skips the test unless a CUDA card is visible (decided here, at
    run time, never at import)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tiny_dir(tmp_path_factory):
    """A benchmark folder with the tiny CPU cells (``tiny.py``)."""
    import tiny
    return tiny.make(tmp_path_factory.mktemp("bench"))
