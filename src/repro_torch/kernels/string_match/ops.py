"""Public wrappers for the string-match kernel (port of
``repro/kernels/string_match/ops.py``).

:func:`string_match` picks by the text's device: a CPU tensor runs the
plain version (``ref.string_match_plain``), a CUDA tensor launches the
Hopper kernel (``kernel.string_match_cuda``) or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.string_match import kernel
from repro_torch.kernels.string_match.ref import string_match_plain

#: String-match launches since import: :func:`string_match` adds one per
#: call, where it launches the kernel (CUDA) or runs its plain version
#: (CPU).
LAUNCH_COUNT = 0


def string_match(text: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """Exact-match start positions of ``pattern`` in ``text``.

    text (N,) uint8 and pattern (P,) uint8 on one device, ``P <= 4096``
    (one search command's coverage).  Returns (N,) int8: 1 at every ``i``
    where ``text[i : i + P] == pattern``."""
    global LAUNCH_COUNT
    if text.dtype != torch.uint8 or pattern.dtype != torch.uint8:
        raise TypeError(f"text/pattern must be uint8, got {text.dtype}/"
                        f"{pattern.dtype}")
    if text.dim() != 1 or pattern.dim() != 1:
        raise ValueError("text and pattern must be 1-D byte tensors")
    if pattern.shape[0] > kernel.MAX_PATTERN:
        raise ValueError(f"pattern of {pattern.shape[0]} bytes exceeds the "
                         f"{kernel.MAX_PATTERN}-byte search coverage")
    if pattern.device != text.device:
        raise ValueError(f"text on {text.device}, pattern on "
                         f"{pattern.device}")
    if text.device.type == "cpu":
        LAUNCH_COUNT += 1
        return string_match_plain(text, pattern)
    if text.device.type == "cuda":
        out = kernel.string_match_cuda(text.contiguous(),
                                       pattern.contiguous())
        LAUNCH_COUNT += 1
        return out
    raise ValueError(f"unsupported device {text.device}")


def count_matches(text: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """Number of match starts, as a 0-d int64 tensor on the text's device."""
    return count_flags(string_match(text, pattern))


#: int64 words summed per byte lane: 255 flags of 0/1 never carry out of
#: their byte.
_LANE_WORDS = 255


def count_flags(flags: torch.Tensor) -> torch.Tensor:
    """Exact number of ones in (N,) int8 0/1 flags, as a 0-d int64 tensor,
    without widening them.

    ``flags.sum(dtype=torch.int64)`` and ``torch.count_nonzero`` both
    first materialise an (N,) int64 copy on the card (8N and 9N bytes at
    the peak).  Here the flags are read as int64 words of 8 byte lanes;
    summing 255 words adds each lane's flags into its own byte with no
    carry, and the lanes of the (N / 2040,) sums are added last, so the
    extra memory is N / 16 bytes.  ``flags`` must start at an 8-byte
    aligned storage offset (a fresh allocation does)."""
    n = flags.shape[0]
    body = n // (8 * _LANE_WORDS) * (8 * _LANE_WORDS)
    tail = flags[body:].sum(dtype=torch.int64)      # under 2040 flags
    if body == 0:
        return tail
    lanes = flags[:body].view(torch.int64).view(-1, _LANE_WORDS).sum(dim=1)
    shifts = torch.arange(0, 64, 8, dtype=torch.int64, device=flags.device)
    return ((lanes[:, None] >> shifts) & 0xFF).sum() + tail
