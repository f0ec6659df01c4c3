"""Bind the Hopper kernel of the hopscotch window lookup.

``csrc/hopscotch_lookup.cu`` exports a plain C launcher; ``kernels/build.py``
compiles it with ``nvcc`` for ``sm_90a`` at first use and loads it with
``ctypes``.  Nothing is built when this module is imported.
:func:`hopscotch_lookup_cuda` takes CUDA tensors only; the
device-dispatching wrapper is ``ops.hopscotch_lookup_device``.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import KernelLibrary

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "hopscotch_lookup.cu"


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """The lookup library (built once per source version)."""
    kl = build.compile_and_load(_SRC, "hopscotch_lookup")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    kl.lib.hopscotch_lookup_launch.argtypes = (
        [vp] * 6 + [ctypes.c_long, ci, ci, vp])
    kl.lib.hopscotch_lookup_launch.restype = ci
    return kl


def hopscotch_lookup_cuda(table_lo: torch.Tensor, table_hi: torch.Tensor,
                          homes: torch.Tensor, q_lo: torch.Tensor,
                          q_hi: torch.Tensor, *, window: int) -> torch.Tensor:
    """Launch on the current stream (no synchronisation).  All operands
    int32, contiguous, on one CUDA device; returns the (Q,) int32 first
    match offsets (-1 = miss), allocated here."""
    build.check_cuda_operands("hopscotch_lookup_cuda", table_lo, table_hi,
                              homes, q_lo, q_hi)
    kl = library()
    q = homes.shape[0]
    out = torch.empty(q, dtype=torch.int32, device=table_lo.device)
    with build.on_device(table_lo):
        kl.check(kl.lib.hopscotch_lookup_launch(
            table_lo.data_ptr(), table_hi.data_ptr(), homes.data_ptr(),
            q_lo.data_ptr(), q_hi.data_ptr(), out.data_ptr(),
            table_lo.shape[0], q, window, build.stream_of(table_lo)))
    return out
