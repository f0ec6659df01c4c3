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

#: The flat search's legal column blocks (4 columns a thread, one to eight
#: warps) and the most query blocks its grid takes (the grid's y limit).
FLAT_BLOCK_C = (128, 256, 512, 1024)
FLAT_MAX_GRID_Y = 65535
#: The cold pair's constants: queries staged per chunk, SMs to cover,
#: blocks to aim for (about two waves).
_Q_CHUNK, _SMS, _TARGET_BLOCKS = 64, 132, 2048


def flat_geometry(q: int, c: int) -> tuple[int, int]:
    """The flat search's cold ``(block_q, block_c)`` for a (Q, R) x (R, C)
    search: the widest block, down to one warp, whose grid still covers
    the card's SMs, then queries split only as finely as about two waves
    of blocks need.  The pair the launcher took before it was given one,
    and the answer of a cold autotune cache."""
    q_chunks = max(-(-q // _Q_CHUNK), 1)
    block_c = FLAT_BLOCK_C[-1]
    while block_c > FLAT_BLOCK_C[0] and -(-c // block_c) * q_chunks < _SMS:
        block_c //= 2
    col_blocks = max(-(-c // block_c), 1)
    grid_y = min(-(-_TARGET_BLOCKS // col_blocks), q_chunks, FLAT_MAX_GRID_Y)
    return max(-(-q // grid_y), 1), block_c


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
    kl.lib.xam_search_launch.argtypes = [_VP] * 4 + [_CI] * 7 + [_VP]
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
                    masks: torch.Tensor, *, block_q: int,
                    block_c: int) -> torch.Tensor:
    """Launch the flat search kernel on the current stream (no
    synchronisation), ``block_q`` queries by ``block_c`` columns a thread
    block.

    keys/masks (Q, R) int8 {0,1}; data (R, C) int8 or (Rp, C) uint8
    packed words with ``Rp * 8 >= R``; all contiguous CUDA tensors on one
    device.  Returns the (Q, C) int8 bitmap, allocated here.  An all-zero
    mask row matches every column.  Raises ``RuntimeError`` if the
    launcher refuses the pair (``block_c`` not in ``FLAT_BLOCK_C``,
    ``block_q`` under 1, over 65535 query blocks)."""
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
            block_q, block_c, build.stream_of(data)))
    return out


def empty_kernel_cuda(device: torch.device | str = "cuda") -> None:
    """Launch one empty kernel (one block) on the current stream: the
    launch floor a small search is measured against.  Not a search: it
    counts as no launch of the flat search."""
    kl = flat_library()
    with torch.cuda.device(device):
        kl.check(kl.lib.xam_search_floor_launch(
            torch.cuda.current_stream(device).cuda_stream))
