"""Bind the Hopper kernels of the XAM search.

``csrc/xam_multiset.cu`` (the fused multi-set first-match search) and
``csrc/xam_search.cu`` (the flat masked search, a (Q, C) bitmap) each
export a plain C launcher (both include the column loaders of
``csrc/xam_columns.cuh``); ``kernels/build.py`` compiles them with
``nvcc`` for ``sm_90a`` at first use and loads them with ``ctypes``.
Nothing is built when this module is imported.

The functions here take CUDA tensors only; the device-dispatching
wrappers the callers use are ``ops.xam_search_multiset_device`` and
``ops.xam_search``.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.build import KernelLibrary

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
#: Key rows both searches take (16 words of 32 bits in registers).
MAX_KEY_BITS = 512
#: Columns and query blocks travel as C ints to the multi-set launcher.
MAX_INT32 = 2 ** 31 - 1
_VP, _CI = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """The multi-set search library (built once per source version)."""
    kl = build.compile_and_load(_CSRC / "xam_multiset.cu", "xam_multiset")
    kl.lib.xam_multiset_launch.argtypes = [_VP] * 7 + [_CI] * 7 + [_VP]
    kl.lib.xam_multiset_launch.restype = _CI
    return kl


@functools.lru_cache(maxsize=None)
def flat_library() -> KernelLibrary:
    """The flat search library (built once per source version)."""
    kl = build.compile_and_load(_CSRC / "xam_search.cu", "xam_search")
    kl.lib.xam_search_launch.argtypes = [_VP] * 4 + [_CI] * 5 + [_VP]
    kl.lib.xam_search_launch.restype = _CI
    kl.lib.xam_search_floor_launch.argtypes = [_VP]
    kl.lib.xam_search_floor_launch.restype = _CI
    return kl


def xam_search_multiset_cuda(keys: torch.Tensor, masks: torch.Tensor,
                             planes: torch.Tensor, valid: torch.Tensor,
                             block_sets: torch.Tensor,
                             live_blocks: torch.Tensor, *,
                             block_q: int) -> torch.Tensor:
    """Launch the multi-set kernel on the current stream (no
    synchronisation).

    Operands as ``ops.xam_search_multiset_device`` documents, already
    validated there except for what only the card imposes; all must be
    contiguous CUDA tensors on one device.  Returns the (Q,) int32 result,
    allocated here with ``torch.empty``.  Raises ``RuntimeError`` if the
    launch is refused."""
    build.check_cuda_operands("xam_search_multiset_cuda", planes, keys,
                              masks, valid, block_sets, live_blocks)
    q, r = keys.shape
    n_sets, rp, c = planes.shape
    if r > MAX_KEY_BITS:
        raise ValueError(f"key rows {r} exceed the kernel's {MAX_KEY_BITS}")
    if max(c, q // block_q) > MAX_INT32:
        raise ValueError(f"{c} columns or {q // block_q} query blocks exceed "
                         f"the launcher's {MAX_INT32}")
    kl = library()
    out = torch.empty(q, dtype=torch.int32, device=planes.device)
    with build.on_device(planes):
        kl.check(kl.lib.xam_multiset_launch(
            keys.data_ptr(), masks.data_ptr(), planes.data_ptr(),
            valid.data_ptr(), block_sets.data_ptr(), live_blocks.data_ptr(),
            out.data_ptr(), q // block_q, n_sets, block_q, r, rp, c,
            int(planes.dtype == torch.uint8), build.stream_of(planes)))
    return out


def xam_search_cuda(keys: torch.Tensor, data: torch.Tensor,
                    masks: torch.Tensor) -> torch.Tensor:
    """Launch the flat search kernel on the current stream (no
    synchronisation).

    keys/masks (Q, R) int8 {0,1}; data (R, C) int8 or (Rp, C) uint8
    packed words with ``Rp * 8 >= R``; all contiguous CUDA tensors on one
    device.  Returns the (Q, C) int8 bitmap, allocated here.  An all-zero
    mask row matches every column."""
    build.check_cuda_operands("xam_search_cuda", data, keys, masks)
    q, r = keys.shape
    rp, c = data.shape
    if r > MAX_KEY_BITS:
        raise ValueError(f"key rows {r} exceed the kernel's {MAX_KEY_BITS}")
    kl = flat_library()
    out = torch.empty((q, c), dtype=torch.int8, device=data.device)
    with build.on_device(data):
        kl.check(kl.lib.xam_search_launch(
            keys.data_ptr(), masks.data_ptr(), data.data_ptr(),
            out.data_ptr(), q, r, rp, c, int(data.dtype == torch.uint8),
            build.stream_of(data)))
    return out


def empty_kernel_cuda(device: torch.device | str = "cuda") -> None:
    """Launch one empty kernel (one block) on the current stream: the
    launch floor a small search is measured against.  Not a search: it
    counts as no launch of the flat search."""
    kl = flat_library()
    with torch.cuda.device(device):
        kl.check(kl.lib.xam_search_floor_launch(
            torch.cuda.current_stream(device).cuda_stream))
