"""Build and bind the Hopper kernel for the fused multi-set XAM search.

``csrc/xam_multiset.cu`` exports a plain C launcher; it is compiled with
``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` of the checkout on
first use (named by a hash of the source, so an edited source never
loads a stale library) and loaded with ``ctypes``.  Nothing is built
when this module is imported.

:func:`xam_search_multiset_cuda` takes CUDA tensors only; the
device-dispatching wrapper that the serving path calls is
``ops.xam_search_multiset_device``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import torch

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "xam_multiset.cu"
#: Build output: ``build/repro_torch/`` at the root of the checkout.
BUILD_DIR = pathlib.Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: Largest dynamic shared memory one block may use on Hopper.
MAX_SMEM_BYTES = 232_448
MAX_KEY_BITS = 512


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: pathlib.Path
    build_seconds: float     # 0.0 when an up-to-date build was reused
    build_log: str           # nvcc/ptxas output (registers, shared memory)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): cannot build "
                       f"{_SRC.name}")


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """Compile (once per source version) and load the kernel library."""
    tag = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    so = BUILD_DIR / f"libxam_multiset_{tag}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{_SRC.name}:\n{log}")
        os.replace(tmp, so)               # atomic against a parallel build
    lib = ctypes.CDLL(str(so))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.xam_multiset_launch.argtypes = [vp] * 7 + [ci] * 7 + [vp]
    lib.xam_multiset_launch.restype = ci
    lib.xam_multiset_error_string.argtypes = [ci]
    lib.xam_multiset_error_string.restype = ctypes.c_char_p
    return KernelLibrary(lib, so, seconds, log)


def smem_bytes(r: int, c: int) -> int:
    """Dynamic shared memory of one live block (mirrors the C helper)."""
    return -(-r // 32) * c * 4 + -(-c // 4) * 4


def xam_search_multiset_cuda(keys: torch.Tensor, masks: torch.Tensor,
                             planes: torch.Tensor, valid: torch.Tensor,
                             block_sets: torch.Tensor,
                             live_blocks: torch.Tensor, *,
                             block_q: int) -> torch.Tensor:
    """Launch the kernel on the current stream (no synchronisation).

    Operands as ``ops.xam_search_multiset_device`` documents, already
    validated there except for what only the card imposes; all must be
    contiguous CUDA tensors on one device.  Returns the (Q,) int32 result,
    allocated here with ``torch.empty``.  Raises ``RuntimeError`` if the
    launch is refused."""
    ops_ = (keys, masks, planes, valid, block_sets, live_blocks)
    dev = planes.device
    if dev.type != "cuda" or any(t.device != dev for t in ops_):
        raise ValueError("xam_search_multiset_cuda needs every operand on "
                         f"one CUDA device; got {[str(t.device) for t in ops_]}")
    if not all(t.is_contiguous() for t in ops_):
        raise ValueError("xam_search_multiset_cuda needs contiguous operands")
    q, r = keys.shape
    n_sets, rp, c = planes.shape
    if r > MAX_KEY_BITS:
        raise ValueError(f"key rows {r} exceed the kernel's {MAX_KEY_BITS}")
    smem = smem_bytes(r, c)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"a {r}x{c} plane tile needs {smem} bytes of shared "
                         f"memory; the card allows {MAX_SMEM_BYTES}")
    kl = library()
    out = torch.empty(q, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = kl.lib.xam_multiset_launch(
        keys.data_ptr(), masks.data_ptr(), planes.data_ptr(),
        valid.data_ptr(), block_sets.data_ptr(), live_blocks.data_ptr(),
        out.data_ptr(), q // block_q, n_sets, block_q, r, rp, c,
        int(planes.dtype == torch.uint8), stream)
    if err != 0:
        msg = kl.lib.xam_multiset_error_string(err).decode()
        raise RuntimeError(f"xam_multiset launch failed: CUDA error {err} "
                           f"({msg})")
    return out
