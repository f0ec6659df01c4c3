"""Chunk fingerprinting for the prefix index (port of the hashing half of
``repro/data/pipeline.py``).

Murmur3's 32-bit finalizer is the hash core: token chunks fold through it
into uint32 fingerprints, which the serving index stores in its CAM
columns and uses to key KV slabs.  Host-side numpy, bit-identical to the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


def murmur3_fmix32(x: torch.Tensor) -> torch.Tensor:
    """Murmur3 finalizer on a tensor of uint32 values held in int64 (torch
    has no full uint32 arithmetic); returns int64 in ``[0, 2**32)``."""
    x = x.to(torch.int64) & _MASK32
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _MASK32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _MASK32
    x = x ^ (x >> 16)
    return x


def murmur3_np(x: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):   # wraparound is the point
        x = x.astype(np.uint32)
        x ^= x >> 16
        x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
        x ^= x >> 13
        x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
        x ^= x >> 16
    return x


def fingerprint_blocks(tokens: np.ndarray, block: int = 16) -> np.ndarray:
    """(B, S) int32 -> (B, S//block) uint32 rolling murmur fingerprints."""
    tokens = np.asarray(tokens)
    b, s = tokens.shape
    nb = s // block
    t = tokens[:, :nb * block].reshape(b, nb, block).astype(np.uint32)
    acc = np.zeros((b, nb), np.uint32)
    for i in range(block):
        acc = murmur3_np(acc ^ t[:, :, i])
    return acc


def prefix_fingerprint_blocks(tokens: np.ndarray,
                              block: int = 16) -> np.ndarray:
    """(B, S) int32 -> (B, S//block) uint32 prefix-CHAINED fingerprints:
    ``fp_i = fmix(fp_{i-1} ^ h(chunk_i))``, so equal fingerprints imply
    equal entire prefixes — the identity KV-slab reuse needs."""
    blocks = fingerprint_blocks(tokens, block)
    out = np.empty_like(blocks)
    acc = np.zeros(blocks.shape[0], np.uint32)
    for i in range(blocks.shape[1]):
        acc = murmur3_np(acc ^ blocks[:, i])
        out[:, i] = acc
    return out
