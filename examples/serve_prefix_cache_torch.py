"""Serving example on the PyTorch port: batched prefill+decode with the
MonarchKVIndex prefix cache (the port's counterpart of
``examples/serve_prefix_cache.py``).

    PYTHONPATH=src python examples/serve_prefix_cache_torch.py [--requests 24]
    PYTHONPATH=src python examples/serve_prefix_cache_torch.py --device cpu

Requests share zipf-distributed prompt prefixes; the index answers "is
this chunk's KV already resident?" with ONE fused multi-set XAM search
per request batch (chained PREFIX fingerprints — equal fingerprint means
equal entire prefix): on the card the multi-set CUDA kernel
(``kernels/xam_search/csrc/xam_multiset.cu``), on the CPU its plain
version.  It admits chunks under the no-allocate + t_MWW-throttled
policy and rotates placement for wear evenness.  A hit is not just
counted: the stored KV slabs are RESTORED into the decode cache and
prefill runs only over the suffix, from its RoPE offset
(``repro_torch.serve.resume``).  The model is reduced yi-9b with seeded
random weights (``transformer.init_params``) on ``--device``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch.serve import run_request_loop
from repro_torch.models import transformer
from repro_torch.serve.admit_queue import AdmitQueue
from repro_torch.serve.kv_index import (CHUNK_TOKENS, KVIndexConfig,
                                        KVSlabStore, MonarchKVIndex)
from repro_torch.serve.resume import PrefixResumeEngine


def make_requests(n, rng, vocab, n_prefixes=4, prefix_len=64, tail_len=32):
    """Zipf-shared prefixes + unique tails (chat-style traffic)."""
    prefixes = [rng.integers(1, vocab, prefix_len).astype(np.int32)
                for _ in range(n_prefixes)]
    reqs = []
    for _ in range(n):
        p = prefixes[min(int(rng.zipf(1.5)) - 1, n_prefixes - 1)]
        tail = rng.integers(1, vocab, tail_len).astype(np.int32)
        reqs.append(np.concatenate([p, tail])[None, :])   # (1, S) batches
    return reqs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--decode-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get_arch("yi-9b").reduced()
    rng = np.random.default_rng(0)
    params = transformer.init_params(cfg, seed=0, device=dev)
    # fingerprint="prefix": slab keys must identify the whole prefix.
    idx = MonarchKVIndex(
        KVIndexConfig(n_sets=8, admit_after_reads=1, fingerprint="prefix"),
        slab_store=KVSlabStore(), device=dev)
    admit_q = AdmitQueue(idx)

    reqs = make_requests(args.requests, rng, cfg.vocab_size)
    max_seq = reqs[0].shape[1] + args.decode_tokens
    engine = PrefixResumeEngine(params, cfg, max_seq=max_seq, index=idx,
                                decode_tokens=args.decode_tokens, device=dev)
    prefill_fn, decode_fn = engine.request_fns()

    t0 = time.time()
    try:
        recs = run_request_loop(admit_q, reqs, prefill_fn=prefill_fn,
                                decode_fn=decode_fn)
    finally:
        admit_q.close()
    dt = time.time() - t0

    tokens_total = sum(r.chunks for r in recs) * CHUNK_TOKENS
    tokens_resumed = sum(r.resumed_chunks for r in recs) * CHUNK_TOKENS
    s = idx.stats
    print(f"[serve] {args.requests} requests, {args.decode_tokens} decode "
          f"tokens each, {dt:.1f}s total")
    print(f"[index] chunk hit rate {idx.hit_rate:.1%} "
          f"({s.chunk_hits}/{s.chunk_hits + s.chunk_misses}); "
          f"{s.searches} CAM searches")
    print(f"[index] prefix KV resumed: {tokens_resumed}/{tokens_total} "
          f"prompt tokens ({tokens_resumed / max(tokens_total, 1):.1%}) — "
          f"prefill compute actually skipped, decode bit-identical "
          f"(slab store {idx.slab_store.resident_bytes / 1e6:.2f} MB)")
    print(f"[index] durability policy: {s.admissions} admissions, "
          f"{s.admission_skips} no-allocate skips, {s.throttled} t_MWW "
          f"throttles, {s.evictions} evictions, {s.rotations} rotations")
    print(f"[index] install distribution over sets: "
          f"{idx.write_distribution().tolist()}")
    audit = idx.slab_lockstep_report()
    assert not audit["missing_slabs"] and not audit["orphan_slabs"], audit


if __name__ == "__main__":
    main()
