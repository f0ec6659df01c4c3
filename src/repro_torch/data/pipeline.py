"""The training token stream, chunk fingerprinting, YCSB key streams and
CAM dedup — port of ``repro/data/pipeline.py``.

Every training batch is a pure function of (seed, step, shard,
n_shards), so a restarted or rescaled run recomputes any step's batch.
Its zipf draws use numpy 2.0's sampler (``traces._zipf``), so the stream
is the reference's on numpy 2.0 and stays the same on later numpy.

Murmur3's 32-bit finalizer is the hash core: token chunks fold through it
into uint32 fingerprints, which the serving index stores in its CAM
columns and uses to key KV slabs.  Host-side numpy, bit-identical to the
reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data.traces import _zipf
from repro_torch.kernels.xam_search import ops as xam_ops

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


# ---------------------------------------------------------------------------
# Token stream.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


def batch_at(cfg: DataConfig, step: int, shard: int = 0, n_shards: int = 1):
    """Deterministic batch of one shard: ``{"tokens", "labels"}`` int32
    (B/n_shards, S) numpy arrays, zipf tokens hashed into [1, V) with
    every 8th position repeating the one before it."""
    per = cfg.global_batch // n_shards
    rng = np.random.default_rng(
        np.uint64(cfg.seed) * np.uint64(1_000_003)
        + np.uint64(step) * np.uint64(997) + np.uint64(shard))
    z = _zipf(rng, cfg.zipf_a, per * (cfg.seq_len + 1)).reshape(
        per, cfg.seq_len + 1)
    toks = (murmur3_np(z.astype(np.uint32)) % np.uint32(cfg.vocab_size - 1)
            + 1).astype(np.int32)
    toks[:, 8::8] = toks[:, 7:-1:8]
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


# ---------------------------------------------------------------------------
# YCSB-style key-value workloads (paper §9.2.2: YCSB-B zipfian 95/5).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class YcsbConfig:
    n_keys: int
    n_ops: int
    read_fraction: float = 0.95   # YCSB-B
    zipf_a: float = 1.2
    seed: int = 0


def ycsb_ops(cfg: YcsbConfig):
    """Returns (keys uint64, is_read bool) operation stream over a keyspace
    of n_keys existing keys; writes may insert new keys."""
    rng = np.random.default_rng(cfg.seed)
    ranks = rng.zipf(cfg.zipf_a, cfg.n_ops).astype(np.uint64)
    keys = murmur3_np((ranks % np.uint64(cfg.n_keys)).astype(np.uint32)).astype(np.uint64)
    keys = (keys << np.uint64(16)) | (ranks % np.uint64(cfg.n_keys))
    is_read = rng.random(cfg.n_ops) < cfg.read_fraction
    # writes beyond the keyspace are inserts of fresh keys
    fresh = rng.integers(cfg.n_keys, cfg.n_keys * 2, cfg.n_ops).astype(np.uint64)
    keys = np.where(is_read, keys, (murmur3_np(fresh.astype(np.uint32)).astype(np.uint64) << np.uint64(16)) | fresh)
    # 0 is the hash-table EMPTY sentinel (murmur3(0) == 0, so rank
    # multiples of n_keys would produce it)
    keys = np.where(keys == 0, np.uint64(1), keys)
    return keys, is_read


# ---------------------------------------------------------------------------
# CAM dedup over token blocks.
# ---------------------------------------------------------------------------

def dedup_mask(fps: np.ndarray, stored_bits: torch.Tensor) -> np.ndarray:
    """True where a fingerprint already exists in the CAM index plane
    (stored_bits: (32, C) int8 on the device).  One flat XAM search per
    fingerprint batch."""
    flat = torch.from_numpy(np.asarray(fps, np.uint32).reshape(-1).astype(
        np.int64)).to(stored_bits.device)
    hits = xam_ops.xam_search(xam_ops.words_to_bits(flat, 32), stored_bits)
    return (hits == 1).any(dim=1).cpu().numpy().reshape(np.shape(fps))
