"""Prefix-cache resume engine: restore cached KV slabs, prefill the suffix
from its RoPE offset, decode from the combined cache (port of
``repro/serve/resume.py``).

Per request batch (driven by ``launch/serve.py::run_request_loop``):

1. ``lookup`` (through the AdmitQueue) answers which leading chunks of
   the prompt are cached — one fused XAM search for the whole batch.
2. :meth:`PrefixResumeEngine.prefill` fetches the hit chunks' KV slabs
   from the index's :class:`~repro_torch.serve.kv_index.KVSlabStore`,
   assembles them into ``prefix_kv`` and prefills ONLY the suffix tokens,
   at their original absolute positions.
3. The chunks it did compute are sliced into per-chunk slabs
   (:class:`PrefillResult`) for the loop to stage with its admission
   submit.
4. :meth:`PrefixResumeEngine.decode` greedily decodes from the cache.

Ground rules (as in the reference): the index must hash with
``fingerprint="prefix"``; at least the last prompt token is always
recomputed; a hit whose slab is missing truncates the resume run; only
attention layers resume.

Slabs stay as tensors on the model's device (the reference copied them to
host numpy arrays); ``KVSlabStore.resident_bytes`` counts the same bytes.

Over a mesh (placed parameters, one process per mesh position, each with
its own index replica and slab store) a slab is a ``DTensor``: this
call's KV rows are gathered over the data axes (raw collectives), so
every process holds every row of its own KV heads, and a slab keeps them
placed so.  A restored prefix is concatenated from the slabs and placed
back by ``cache_specs``, its rows split as the cache's are.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.dist import sharding
from repro_torch.models import transformer
from repro_torch.pytree import tree_leaves, tree_map
from repro_torch.serve.kv_index import CHUNK_TOKENS, MonarchKVIndex
from repro_torch.serve.step import (greedy, make_decode_step,
                                    make_resume_prefill_step)


@dataclasses.dataclass
class PrefillResult:
    """What a resume-aware ``prefill_fn`` returns to the request loop:
    the decode ``state``, the freshly computed ``slabs`` ({fp: kv slab})
    to stage at submit time, and the chunk counters."""
    state: Any
    slabs: dict | None = None
    resumed_chunks: int = 0
    computed_chunks: int = 0


# KV tree leaves are (G, B, S, KV, dh) in a layer group and (B, S, KV, dh)
# in a remainder block, so axes are addressed from the right, as in the
# reference: batch fourth-from-last, sequence third-from-last.

def _slice_chunk(tree: dict, row: int, lo: int, hi: int) -> dict:
    """One row's [lo, hi) token span of a kv tree, as its own tensors
    (a copy, so the slab does not pin the whole batch's KV)."""
    return tree_map(lambda a: a[..., row:row + 1, lo:hi, :, :].clone(), tree)


def _concat(parts: list, axis_from_end: int) -> dict:
    return tree_map(
        lambda *xs: torch.cat(xs, dim=xs[0].dim() - axis_from_end), *parts)


def _placed_as_cache(kv: dict) -> dict:
    """Placed slabs concatenated into a prefix (every row on every
    process) placed as the decode cache is (``cache_specs``: rows over
    the data axes, KV heads over ``model``); no data moves."""
    leaf = tree_leaves(kv)[0]
    if not isinstance(leaf, DTensor):
        return kv
    dm = leaf.device_mesh
    specs = sharding.cache_specs(kv, dm)
    return tree_map(lambda a, sp: sharding.redistribute(
        a, sharding.placements(sp, dm.mesh_dim_names)), kv, specs)


def tokens_to_host(tokens: torch.Tensor) -> np.ndarray:
    """(B, T) decoded tokens as an int32 host array, every row on every
    process (a placed array is gathered with raw collectives)."""
    return sharding.full(tokens).cpu().numpy().astype(np.int32)


class PrefixResumeEngine:
    """Prefill/decode pair that serves prefix-cache hits from KV slabs.

    ``params`` live on the model's device; ``cfg`` must be
    attention-only; ``max_seq`` bounds prompt + decode; ``index`` supplies
    the fingerprint scheme (must be ``"prefix"``) and the slab store.
    ``device`` is where the engine runs (default ``"cuda"``, which raises
    without a card) and must be where ``params`` are.  ``on_logits``, if
    given, sees the logits of every greedy step before its argmax."""

    def __init__(self, params: dict, cfg: ArchConfig, *, max_seq: int,
                 index: MonarchKVIndex, decode_tokens: int = 8,
                 device: str | torch.device = "cuda", on_logits=None):
        if not transformer.resume_supported(cfg):
            raise NotImplementedError(
                f"prefix resume needs attention-only layers; {cfg.name} "
                "carries recurrent (SSM) state that chunk slabs cannot "
                "restore")
        if index.cfg.fingerprint != "prefix":
            raise ValueError(
                "PrefixResumeEngine needs KVIndexConfig(fingerprint="
                "'prefix'): per-chunk-independent fingerprints would let "
                "content-equal chunks with different prefixes share KV")
        if index.slab_store is None:
            raise ValueError(
                "PrefixResumeEngine needs an index with an attached "
                "KVSlabStore (MonarchKVIndex(..., slab_store=...))")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # "cuda" is the current card, where params made for "cuda" live
            self.device = torch.device("cuda", torch.cuda.current_device())
        # a placed parameter reports its block's device: this process's
        # card of the mesh
        if params["final_ln"].device != self.device:
            raise ValueError(f"params live on {params['final_ln'].device}, "
                             f"engine device is {self.device}")
        self.params = params
        self.cfg = cfg
        self.max_seq = max_seq
        self.index = index
        self.store = index.slab_store
        self.decode_tokens = decode_tokens
        self._prefill = make_resume_prefill_step(cfg, max_seq)
        self._decode = make_decode_step(cfg, on_logits)
        self.on_logits = on_logits
        self.resumed_chunks = 0          # served from slabs, cumulative
        self.computed_chunks = 0         # recomputed, cumulative
        # Serving workers share one engine: every request gets its own
        # cache and slabs, so the counters are the only shared state.
        self._count_lock = threading.Lock()

    def _resume_run(self, fps: np.ndarray, hits: np.ndarray, s: int) -> int:
        """Longest leading run of chunks servable for EVERY row (hit in the
        index AND slab resident), capped at ``(s-1) // CHUNK_TOKENS`` so at
        least one suffix token is recomputed."""
        b, _ = fps.shape
        cap = max(s - 1, 0) // CHUNK_TOKENS
        run = cap
        for r in range(b):
            k = 0
            while (k < cap and hits[r, k]
                   and self.store.get(int(fps[r, k])) is not None):
                k += 1
            run = min(run, k)
        return run

    def prefill(self, toks: np.ndarray, hits=None) -> PrefillResult:
        """Restore + partial prefill of one request batch.  ``hits`` is
        the lookup answer ((B, n_chunks) bool); ``None`` disables resume
        (full prefill, still returning slabs for admission)."""
        toks = np.asarray(toks, np.int32)
        b, s = toks.shape
        n_chunks = s // CHUNK_TOKENS
        fps = self.index.fingerprints(toks)
        if hits is None:
            hits = np.zeros((b, n_chunks), bool)
        run = self._resume_run(fps, np.asarray(hits, bool), s)
        p_len = run * CHUNK_TOKENS
        prefix_kv = None
        if run > 0:
            prefix_kv = _concat([
                _concat([self.store.get(int(fps[r, k])) for k in range(run)],
                        3)
                for r in range(b)], 4)
            prefix_kv = _placed_as_cache(prefix_kv)
        logits, cache, kv_suffix = self._prefill(
            self.params, {"tokens": toks[:, p_len:]}, prefix_kv)
        kv_suffix = tree_map(sharding.gather_rows, kv_suffix)
        slabs: dict[int, Any] = {}
        for r in range(b):
            for c in range(run, n_chunks):
                fp = int(fps[r, c])
                if fp not in slabs:
                    lo = c * CHUNK_TOKENS - p_len
                    slabs[fp] = _slice_chunk(kv_suffix, r, lo,
                                             lo + CHUNK_TOKENS)
        with self._count_lock:
            self.resumed_chunks += run * b
            self.computed_chunks += (n_chunks - run) * b
        state = {"logits": logits, "cache": cache, "pos": s}
        return PrefillResult(state=state, slabs=slabs,
                             resumed_chunks=run * b,
                             computed_chunks=(n_chunks - run) * b)

    def decode(self, result, n_tokens: int | None = None) -> np.ndarray:
        """Greedy decode from a :meth:`prefill` result (or its ``state``).
        Returns the (B, n_tokens) int32 decoded ids (one device-to-host
        copy at the end); positions continue at the full prompt length.
        The cache in ``state`` is updated in place, and the last emitted
        token is not fed back (its step would only extend the cache)."""
        state = result.state if isinstance(result, PrefillResult) else result
        n = self.decode_tokens if n_tokens is None else n_tokens
        logits, cache, pos = state["logits"], state["cache"], state["pos"]
        if pos + n > self.max_seq:
            raise ValueError(
                f"decode of {n} tokens from position {pos} overflows "
                f"max_seq={self.max_seq}")
        if self.on_logits is not None:
            self.on_logits(logits)
        nxt = greedy(logits)
        outs = []
        for t in range(n):
            outs.append(nxt)
            if t + 1 < n:
                nxt, _, cache = self._decode(self.params, cache, nxt,
                                             pos + t)
        return tokens_to_host(torch.cat(outs, dim=1))

    def request_fns(self, n_tokens: int | None = None):
        """(prefill_fn, decode_fn) pair shaped for ``run_request_loop``;
        decode_fn returns the (B, n_tokens) tokens and stashes them on the
        result's state as ``state["decoded"]``."""
        def prefill_fn(toks, hits):
            return self.prefill(toks, hits)

        def decode_fn(toks, result):
            decoded = self.decode(result, n_tokens)
            result.state["decoded"] = decoded
            return decoded

        return prefill_fn, decode_fn
