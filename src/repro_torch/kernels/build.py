"""Build and load the port's hand-written CUDA kernels.

Every kernel source (``kernels/*/csrc/*.cu``) exports a plain C launcher
and an error-string function.  :func:`compile_and_load` compiles one
source with ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` of the
checkout at first use, names the library by a hash of the source and of
the ``*.cuh`` headers beside it (an edited source or header never loads a
stale library), renames it into place
atomically (two processes, or two threads, may build one source at once),
and loads it with ``ctypes``.  Nothing is built when a module is
imported: the kernel modules call this from their launch path.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

import torch

#: Build output: ``build/repro_torch/`` at the root of the checkout.
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclasses.dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: pathlib.Path
    build_seconds: float     # 0.0 when an up-to-date build was reused
    build_log: str           # nvcc/ptxas output (registers, shared memory)
    prefix: str              # C symbol prefix: <prefix>_launch, ...

    def ptxas_lines(self) -> list[str]:
        """The build log's register and spill lines."""
        return [ln.strip() for ln in self.build_log.splitlines()
                if "registers" in ln or "spill" in ln]

    def check(self, err: int) -> None:
        """Raise ``RuntimeError`` for a nonzero CUDA error code returned
        by the library's launcher."""
        if err != 0:
            fn = getattr(self.lib, f"{self.prefix}_error_string")
            raise RuntimeError(f"{self.prefix} launch failed: CUDA error "
                               f"{err} ({fn(err).decode()})")


def _nvcc(src: pathlib.Path) -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"nvcc not found (PATH or CUDA_HOME): cannot build "
                       f"{src.name}")


def compile_and_load(src: pathlib.Path, prefix: str) -> KernelLibrary:
    """Compile ``src`` (once per source version) and load it.  The caller
    sets the launcher's ``argtypes``; the error-string function is bound
    here."""
    digest = hashlib.sha1(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    tag = digest.hexdigest()[:12]
    so = BUILD_DIR / f"lib{src.stem}_{tag}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(
            f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(src), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{src.name}:\n{log}")
        os.replace(tmp, so)               # atomic against a parallel build
    lib = ctypes.CDLL(str(so))
    err_fn = getattr(lib, f"{prefix}_error_string")
    err_fn.argtypes = [ctypes.c_int]
    err_fn.restype = ctypes.c_char_p
    return KernelLibrary(lib, so, seconds, log, prefix)


def on_device(t: torch.Tensor):
    """``torch.cuda.device`` of ``t``'s card, to hold around a ctypes
    launch: the CUDA runtime launches on the calling thread's current
    device, so a partition on another card than the current one would
    otherwise launch with that card's stream on the wrong device."""
    return torch.cuda.device(t.device)


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the launchers take it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda_operands(name: str, *tensors) -> None:
    """Every operand a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name} needs every operand on one CUDA device; "
                         f"got {[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} needs contiguous operands")
