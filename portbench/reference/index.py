"""Plain model of the prefix index's answers, from the requests alone.

A prompt is cut into chunks of ``chunk`` tokens; a chunk's fingerprint
is a 32-bit murmur3 chain over its tokens (``"block"``), or over every
chunk up to it (``"prefix"``: equal fingerprints then mean equal whole
prefixes).  A fingerprint is held once it has been offered
``admit_after_reads + 1`` times (the no-allocate gate: the first offers
only count); a lookup hits exactly the held fingerprints.  Each set
holds ``set_ways`` of them (the set is the fingerprint's murmur3 modulo
the set count); a set that would overflow needs the index's eviction
order, which this model does not follow, so it raises.  Imports nothing
of the program.
"""
from __future__ import annotations

import numpy as np


def murmur3(x: np.ndarray) -> np.ndarray:
    """The murmur3 32-bit finaliser, elementwise on uint32."""
    x = np.asarray(x, np.uint64) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    x ^= x >> 16
    return x.astype(np.uint32)


def fingerprints(tokens: np.ndarray, scheme: str,
                 chunk: int = 16) -> np.ndarray:
    """(B, S) tokens -> (B, S // chunk) uint32 chunk fingerprints."""
    tokens = np.asarray(tokens, np.int64)
    b, s = tokens.shape
    n = s // chunk
    t = (tokens[:, :n * chunk].reshape(b, n, chunk) & 0xFFFFFFFF).astype(
        np.uint32)
    fp = np.zeros((b, n), np.uint32)
    for i in range(chunk):
        fp = murmur3(fp ^ t[:, :, i])
    if scheme == "block":
        return fp
    if scheme != "prefix":
        raise ValueError(f"fingerprint scheme {scheme!r}")
    out = np.empty_like(fp)
    acc = np.zeros(b, np.uint32)
    for i in range(n):
        acc = murmur3(acc ^ fp[:, i])
        out[:, i] = acc
    return out


class PlainIndex:
    """What the index should answer, offer by offer."""

    def __init__(self, geometry: dict):
        self.scheme = geometry["fingerprint"]
        self.n_sets = int(geometry["n_sets"])
        self.ways = int(geometry["set_ways"])
        self.after = int(geometry["admit_after_reads"])
        self.held: set[int] = set()
        self.offers: dict[int, int] = {}
        self.per_set = np.zeros(self.n_sets, np.int64)

    def lookup(self, tokens: np.ndarray) -> np.ndarray:
        fp = fingerprints(tokens, self.scheme)
        return np.vectorize(lambda f: int(f) in self.held,
                            otypes=[bool])(fp) if fp.size else \
            np.zeros(fp.shape, bool)

    def offer(self, tokens: np.ndarray) -> None:
        for f in np.unique(fingerprints(tokens, self.scheme)).tolist():
            if f in self.held:
                continue
            seen = self.offers.get(f, 0)
            if seen < self.after:
                self.offers[f] = seen + 1
                continue
            s = int(murmur3(np.uint32(f))) % self.n_sets
            if self.per_set[s] >= self.ways:
                raise RuntimeError(f"set {s} full: the model does not "
                                   "follow the index's evictions")
            self.per_set[s] += 1
            self.held.add(f)
            self.offers.pop(f, None)


def mismatches(geometry: dict, events: list) -> tuple[int, int]:
    """Replay ``events`` (``("offer", tokens)`` and ``("lookup", tokens,
    hits)`` in the order the program saw them) and count the lookup
    answers that differ from the plain model's; returns (differing,
    answers compared)."""
    model = PlainIndex(geometry)
    bad = total = 0
    for ev in events:
        if ev[0] == "offer":
            model.offer(ev[1])
        else:
            want = model.lookup(ev[1])
            bad += int((np.asarray(ev[2], bool) != want).sum())
            total += int(want.size)
    return bad, total
