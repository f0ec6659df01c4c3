"""The one traffic generator: a mix's parameters (``traffic/<name>.json``)
and a seed give every batch the benchmark sends.

A request's prompt is the leading part of a document drawn from a pool
(Zipf over the pool's ranks), then a fresh question; its answer is a
number of greedy tokens.  Prompt and answer lengths are lognormal
(``median`` and ``sigma`` of each), taken at their quantile points, so
that every seed sends the same sizes and only their order and the
tokens change:

* the rows of a batch share one prompt length (the program serves a
  batch as one rectangle): one of the ``levels`` quantile points of the
  prompt lengths, each cycle of ``levels`` batches sending every point
  once, in an order drawn from the seed; ``doc_share`` of it, in whole
  index chunks, is the document;
* the rows of a batch take the ``batch`` quantile points of the answer
  lengths, in an order drawn from the seed, and the batch decodes as
  many tokens as its longest answer asks for.

Batch ``i`` is drawn from its own stream (``[seed, "batch", i]``), so it
is the same however many batches a run reaches.
"""
from __future__ import annotations

import statistics

import numpy as np

_DOCS, _BATCH, _SAMPLE, _ORDER, _WARM, _WEIGHTS = 1, 2, 3, 4, 5, 100


def seed_words(seed: int) -> list[int]:
    """A whole-number seed of any size as non-negative 32-bit words (a
    ``SeedSequence`` entropy), so negative and large seeds are fine."""
    seed = int(seed)
    words = [1 if seed < 0 else 0]
    seed = abs(seed)
    while True:
        words.append(seed & 0xFFFFFFFF)
        seed >>= 32
        if not seed:
            return words


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The numpy generator of one stream of ``seed``."""
    return np.random.default_rng(seed_words(seed) + list(stream))


def torch_seed(seed: int) -> int:
    """A 63-bit seed for the weights' ``torch.Generator`` from ``seed``."""
    state = np.random.SeedSequence(seed_words(seed) + [_WEIGHTS])
    hi, lo = state.generate_state(2, np.uint32)
    return ((int(hi) << 32) | int(lo)) & (2 ** 63 - 1)


def lognormal_points(median: float, sigma: float, n: int) -> np.ndarray:
    """The ``n`` quantile points ``(k + 0.5) / n`` of a lognormal."""
    z = [statistics.NormalDist().inv_cdf((k + 0.5) / n) for k in range(n)]
    return median * np.exp(sigma * np.asarray(z))


class Traffic:
    """The batches of one mix under one seed.

    ``spec`` keys: ``batch`` rows a batch; ``prompt_tokens`` and
    ``out_tokens`` the lengths' ``median`` and ``sigma`` (and the prompt
    lengths' ``levels``); ``doc_share`` the document's share of a prompt;
    ``doc_pool`` documents and ``doc_zipf_s`` the exponent over their
    ranks; ``fill_touches`` how often set-up offers each document to the
    index; ``sample_requests`` requests the reference checks.  ``chunk``
    is the index's chunk: prompts and documents are whole chunks."""

    def __init__(self, spec: dict, seed: int, vocab_size: int,
                 chunk: int = 16):
        self.spec = spec
        self.seed = seed
        self.vocab = int(vocab_size)
        self.rows = int(spec["batch"])
        p, a = spec["prompt_tokens"], spec["out_tokens"]
        pts = lognormal_points(p["median"], p["sigma"], int(p["levels"]))
        self.prompt_lens = [max(1, int(round(x / chunk))) * chunk
                            for x in pts]
        share = float(spec.get("doc_share", 0.0))
        self.doc_lens = [int(share * n // chunk) * chunk
                         for n in self.prompt_lens]
        self.answers = np.maximum(1, np.round(lognormal_points(
            a["median"], a["sigma"], self.rows))).astype(np.int64)
        self.decode_tokens = int(self.answers.max())
        pool = int(spec.get("doc_pool", 0)) if max(self.doc_lens) else 0
        self.docs = self._tokens(rng(seed, _DOCS), (pool, max(self.doc_lens)))
        ranks = np.arange(1, pool + 1, dtype=np.float64)
        p = ranks ** -float(spec.get("doc_zipf_s", 0.0))
        self.doc_p = p / p.sum() if pool else p

    def _tokens(self, g: np.random.Generator, shape) -> np.ndarray:
        return g.integers(1, self.vocab, shape, dtype=np.int64).astype(
            np.int32)

    @property
    def max_seq(self) -> int:
        return max(self.prompt_lens) + self.decode_tokens

    def _draw(self, g: np.random.Generator, level: int):
        n, d = self.prompt_lens[level], self.doc_lens[level]
        question = self._tokens(g, (self.rows, n - d))
        answers = g.permutation(self.answers)
        if not len(self.docs):
            return question, answers
        which = g.choice(len(self.docs), size=self.rows, p=self.doc_p)
        return np.concatenate([self.docs[which, :d], question], 1), answers

    def level(self, i: int) -> int:
        """The prompt length level of batch ``i``."""
        cycle, k = divmod(i, len(self.prompt_lens))
        return int(rng(self.seed, _ORDER, cycle).permutation(
            len(self.prompt_lens))[k])

    def batch(self, i: int):
        """Batch ``i``: (rows, prompt length) int32 token ids and the
        rows' answer lengths."""
        return self._draw(rng(self.seed, _BATCH, i), self.level(i))

    def warm_batches(self) -> list:
        """Batches of every prompt length, shortest first, then the
        longest again (its prefill while the last batch's state is
        held), from a stream the window never uses."""
        levels = list(np.argsort(self.prompt_lens))
        return [self._draw(rng(self.seed, _WARM, j), int(lv))
                for j, lv in enumerate(levels + levels[-1:])]

    def fill_batches(self) -> list[np.ndarray]:
        """The documents in batches of ``rows``, as set-up offers them."""
        return [self.docs[i:i + self.rows]
                for i in range(0, len(self.docs), self.rows)]

    def sample(self, lengths) -> np.ndarray:
        """Indices of the requests the reference checks, drawn from the
        seed among the completed ones, whose prompt lengths are
        ``lengths``: ``sample_requests`` (all if fewer) dealt over the
        prompt lengths in turn, the longest first."""
        lengths = np.asarray(lengths)
        k = min(int(self.spec["sample_requests"]), len(lengths))
        pools = [rng(self.seed, _SAMPLE, int(n)).permutation(
                     np.nonzero(lengths == n)[0]).tolist()
                 for n in sorted(set(lengths.tolist()), reverse=True)]
        pick = []
        while len(pick) < k:
            for pool in pools:
                if pool and len(pick) < k:
                    pick.append(pool.pop(0))
        return np.sort(np.asarray(pick, np.int64))
