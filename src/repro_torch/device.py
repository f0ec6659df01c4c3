"""Device resolution shared by the port's entry points.

Entry points (``init_params``, ``MonarchKVIndex``, ``PrefixResumeEngine``,
``launch/serve.py``) default to ``device="cuda"`` and call
:func:`resolve_device`, which raises when no card is visible: the port
never drops to the CPU on its own.  The CPU runs only when the caller
asks for it (``device="cpu"``), as the parity tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` for a CUDA
    device when no card is visible (pass ``device="cpu"`` to run on the
    host explicitly).  ``"meta"`` (shapes and dtypes, no storage: the
    dry run's ``launch/specs.py``) is accepted when the caller names it;
    it is never a default."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is visible; pass "
            "device='cpu' explicitly to run the port on the host")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev
