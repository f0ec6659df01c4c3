"""Bind the Hopper kernel of the sliding string match.

``csrc/string_match.cu`` exports a plain C launcher; ``kernels/build.py``
compiles it with ``nvcc`` for ``sm_90a`` at first use and loads it with
``ctypes``.  Nothing is built when this module is imported.
:func:`string_match_cuda` takes CUDA tensors only; the device-dispatching
wrapper is ``ops.string_match``.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import KernelLibrary

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "string_match.cu"
#: Text bytes per CUDA block (four of the paper's 4 KiB search commands,
#: ``apps/stringmatch.SEARCH_COVERAGE``, which does not depend on it).
TILE = 16384
#: Longest pattern the kernel stages in shared memory.
MAX_PATTERN = 4096


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """The string-match library (built once per source version)."""
    kl = build.compile_and_load(_SRC, "string_match")
    vp = ctypes.c_void_p
    kl.lib.string_match_launch.argtypes = [vp] * 3 + [ctypes.c_long,
                                                      ctypes.c_int, vp]
    kl.lib.string_match_launch.restype = ctypes.c_int
    return kl


def string_match_cuda(text: torch.Tensor,
                      pattern: torch.Tensor) -> torch.Tensor:
    """Launch on the current stream (no synchronisation).  text (N,) and
    pattern (P,) uint8, contiguous, on one CUDA device, P <= 4096; the
    text may start at any byte offset (a view such as ``text[3:]``).
    Returns the (N,) int8 flags, allocated here (16-byte aligned, as the
    kernel's wide stores need)."""
    build.check_cuda_operands("string_match_cuda", text, pattern)
    kl = library()
    out = torch.empty(text.shape[0], dtype=torch.int8, device=text.device)
    with build.on_device(text):
        kl.check(kl.lib.string_match_launch(
            text.data_ptr(), pattern.data_ptr(), out.data_ptr(),
            text.shape[0], pattern.shape[0], build.stream_of(text)))
    return out
