"""Serving launcher: batched prefill + decode with the MonarchKVIndex prefix
cache, on one CUDA card (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --requests 8 --decode-tokens 8 [--reduced] [--device cuda|cpu]

The request loop (:func:`run_request_loop`) is the reference's, line for
line: lookup -> prefill -> submit -> decode, closed- or open-loop.  The
index, the admission queue and the model all live on ``--device``
(default ``cuda``; without a visible card the launcher raises rather than
run on the CPU).  Mesh placement flags are dropped: the port runs one
device, so ``--n-shards`` set shards co-locate on it (the unsharded
single-launch path).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.serve import step as serve_step
from repro_torch.serve.admit_queue import AdmitQueue
from repro_torch.serve.kv_index import (CHUNK_TOKENS, KVIndexConfig,
                                        KVSlabStore, MonarchKVIndex)
from repro_torch.serve.resume import PrefillResult, PrefixResumeEngine


@dataclasses.dataclass
class RequestRecord:
    """Per-request front-end accounting from :func:`run_request_loop`
    (latency counted from the SCHEDULED arrival when open-loop)."""
    arrival_s: float            # scheduled (open-loop) or actual start
    start_s: float              # when the loop began serving it
    done_s: float               # when service + submit finished
    latency_s: float            # done_s - arrival_s
    chunks: int                 # whole CHUNK_TOKENS chunks looked up
    hit_chunks: int             # of which already cached
    admitted: bool              # admission submit accepted
    retried: bool               # defer policy: submit retried after decode
    dropped: bool               # retry rejected too — admission forgone
    resumed_chunks: int = 0     # chunks restored from KV slabs (resume path)
    decoded: np.ndarray | None = None   # decode_fn's (B, T) greedy tokens


def run_request_loop(admit_q: AdmitQueue, requests, *, prefill_fn,
                     decode_fn=None, arrivals_s=None, now_fn=time.monotonic,
                     sleep_fn=time.sleep, retry_wait_s=0.05, on_batch=None):
    """THE serving request loop: lookup -> prefill -> submit -> decode.

    ``prefill_fn(tokens, hits)`` computes the batch's KV before the
    admission submit; ``decode_fn(tokens, state)`` runs after it, so the
    admission worker overlaps decode, and its return value is surfaced as
    ``RequestRecord.decoded``.  ``arrivals_s`` makes the loop open-loop;
    ``retry_wait_s`` bounds the drain-wait before the one retry of a
    deferred submit; ``on_batch(i, tokens, hits, record)`` runs after each
    batch.  Returns the list of :class:`RequestRecord`."""
    t0 = now_fn()
    records: list[RequestRecord] = []
    for i, toks in enumerate(requests):
        if arrivals_s is not None:
            arrival = float(arrivals_s[i])
            wait = arrival - (now_fn() - t0)
            if wait > 0:
                sleep_fn(wait)
        start = now_fn() - t0
        if arrivals_s is None:
            arrival = start
        hits = admit_q.lookup(toks)
        state = prefill_fn(toks, hits)
        # Resume-aware prefills return a PrefillResult: its freshly
        # computed KV slabs are staged WITH the submit (lockstep).
        slabs = state.slabs if isinstance(state, PrefillResult) else None
        resumed = state.resumed_chunks if isinstance(state, PrefillResult) else 0
        submit = (lambda: admit_q.submit_tokens(toks, slabs=slabs)) \
            if slabs is not None else (lambda: admit_q.submit_tokens(toks))
        accepted = submit()
        decoded = decode_fn(toks, state) if decode_fn is not None else None
        retried = dropped = False
        if not accepted:               # defer: retry once after decode
            retried = True
            pending_fn = getattr(admit_q, "pending", None)
            if pending_fn is not None and retry_wait_s > 0:
                deadline = now_fn() + retry_wait_s
                while pending_fn() > 0 and now_fn() < deadline:
                    sleep_fn(retry_wait_s / 16)
            accepted = submit()
            dropped = not accepted
            if dropped and slabs:      # forgone admission: staged slabs
                store = admit_q.index.slab_store      # are garbage
                for fp in slabs:
                    store.discard(fp)
        done = now_fn() - t0
        rec = RequestRecord(
            arrival_s=arrival, start_s=start, done_s=done,
            latency_s=done - arrival,
            chunks=int(hits.size), hit_chunks=int(hits.sum()),
            admitted=bool(accepted), retried=retried, dropped=dropped,
            resumed_chunks=resumed, decoded=decoded)
        records.append(rec)
        if on_batch is not None:
            on_batch(i, toks, hits, rec)
    return records


def build_model_fns(params, cfg, *, max_seq, decode_tokens, index=None,
                    resume=False):
    """(prefill_fn, decode_fn, engine) for :func:`run_request_loop`.

    With ``resume=True`` the pair comes from a :class:`PrefixResumeEngine`
    over ``index`` (which must carry a slab store), and ``engine`` is that
    engine; otherwise it is the plain prefill/greedy-decode pair and
    ``engine`` is None.  Either way ``decode_fn`` returns the
    ``(B, decode_tokens)`` greedy tokens.  Everything runs where
    ``params`` live."""
    device = params["final_ln"].device
    if resume:
        engine = PrefixResumeEngine(params, cfg, max_seq=max_seq,
                                    index=index,
                                    decode_tokens=decode_tokens,
                                    device=device)
        prefill_fn, decode_fn = engine.request_fns()
        return prefill_fn, decode_fn, engine

    prefill_step = serve_step.make_prefill_step(cfg, max_seq)
    decode_step = serve_step.make_decode_step(cfg)

    def model_prefill(toks, hits):
        return prefill_step(params, {"tokens": toks})

    def model_decode(toks, state):
        logits, cache = state
        nxt = torch.argmax(logits, dim=-1)[:, None]
        outs = [nxt]
        for t in range(decode_tokens - 1):
            nxt, logits, cache = decode_step(params, cache, nxt,
                                             toks.shape[1] + t)
            outs.append(nxt)
        return torch.cat(outs, dim=1).cpu().numpy().astype(np.int32)

    return model_prefill, model_decode, None


@dataclasses.dataclass
class ServeRun:
    """Everything one :func:`serve` call built and returned: the request
    records and batches plus the index, engine (None off the resume
    path), parameters and config, for callers that inspect or reuse
    them."""
    records: list
    batches: list
    index: MonarchKVIndex
    engine: PrefixResumeEngine | None
    params: dict
    cfg: configs.ArchConfig
    seconds: float


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve batched requests through the Monarch prefix "
                    "index on one device.")
    ap.add_argument("--arch", default="yi-9b", choices=sorted(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the model and the index "
                         "(default cuda; cpu only when asked)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=96)
    ap.add_argument("--decode-tokens", type=int, default=8)
    ap.add_argument("--no-resume", action="store_true",
                    help="disable the prefix-cache DECODE resume path "
                         "(hits still counted, every request recomputes "
                         "its full prefill)")
    ap.add_argument("--lifetime-years", type=float, default=None,
                    help="target index lifetime (derives the t_MWW "
                         "admission window; default: fixed window_ops)")
    ap.add_argument("--endurance", type=float, default=1e8,
                    help="cell endurance for --lifetime-years")
    ap.add_argument("--m-writes", type=int, default=3,
                    help="per-way write budget per t_MWW window")
    ap.add_argument("--ops-per-sec", type=float, default=1e6,
                    help="expected index op rate for --lifetime-years "
                         "under --wear-clock ops")
    ap.add_argument("--wear-clock", default="ops", choices=["ops", "wall"],
                    help="t_MWW cycle domain: index ops or wall time")
    ap.add_argument("--n-shards", type=int, default=1,
                    help="set-axis shards of the index (must divide its 8 "
                         "sets; co-located on the one device)")
    ap.add_argument("--sync-admit", action="store_true",
                    help="admit inline instead of behind the async "
                         "AdmitQueue")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="bound on fingerprints pending admission")
    ap.add_argument("--admit-policy", default="block",
                    choices=["block", "shed", "defer"],
                    help="back-pressure when --max-pending is hit")
    return ap.parse_args(argv)


def serve(args: argparse.Namespace) -> ServeRun:
    """Build the index, queue and model from ``args``, serve the
    requests, drain the queue and print the reports."""
    device = resolve_device(args.device)
    cfg = configs.get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode service")

    rng = np.random.default_rng(0)
    max_seq = args.prompt_len + args.decode_tokens
    resume = not args.no_resume and transformer.resume_supported(cfg)
    fp_scheme = "prefix" if resume else "block"
    if args.lifetime_years is not None:
        kv_cfg = KVIndexConfig.with_lifetime(
            t_life_years=args.lifetime_years, endurance=args.endurance,
            ops_per_second=args.ops_per_sec, m_writes=args.m_writes,
            clock=args.wear_clock, n_sets=8, n_shards=args.n_shards,
            fingerprint=fp_scheme)
        unit = "ops" if args.wear_clock == "ops" else "us of wall time"
        print(f"[serve] lifetime target {args.lifetime_years}y @ "
              f"{args.endurance:.0e} endurance -> t_MWW window = "
              f"{kv_cfg.window_ops} {unit}, M={kv_cfg.m_writes}")
    else:
        kv_cfg = KVIndexConfig(n_sets=8, m_writes=args.m_writes,
                               clock=args.wear_clock, n_shards=args.n_shards,
                               fingerprint=fp_scheme)
    idx = MonarchKVIndex(kv_cfg, slab_store=KVSlabStore() if resume else None,
                         device=device)
    if not resume and not args.no_resume:
        print(f"[serve] resume path off: {cfg.name} has recurrent layers "
              "(prefix hits counted, prefill not skipped)")
    if args.n_shards > 1:
        print(f"[serve] index sharded over {args.n_shards} set shards "
              f"({idx.sets_per_shard} sets each; co-located, 1 device "
              "(collapsed to the unsharded single-launch path))")
    admit_q = AdmitQueue(idx, background=not args.sync_admit,
                         max_pending=args.max_pending,
                         policy=args.admit_policy)

    params = transformer.init_params(cfg, seed=0, device=device)
    model_prefill, model_decode, engine = build_model_fns(
        params, cfg, max_seq=max_seq, decode_tokens=args.decode_tokens,
        index=idx, resume=resume)

    # shared prefix -> index hits after the first batch
    prefix = rng.integers(1, cfg.vocab_size,
                          args.prompt_len // 2).astype(np.int32)
    batches = []
    served = 0
    while served < args.requests:
        b = min(args.batch, args.requests - served)
        tails = rng.integers(
            1, cfg.vocab_size,
            (b, args.prompt_len - len(prefix))).astype(np.int32)
        batches.append(np.concatenate(
            [np.tile(prefix, (b, 1)), tails], axis=1))
        served += b
    n_prefix_chunks = len(prefix) // CHUNK_TOKENS

    def report(i, toks, hits, rec):
        cached = (f"{hits[:, :n_prefix_chunks].mean():.0%}"
                  if n_prefix_chunks else "n/a")
        extra = (f", resumed {rec.resumed_chunks}/{rec.chunks} chunks"
                 if resume else "")
        n_dec = rec.decoded.shape[1] if rec.decoded is not None else 0
        print(f"[serve] batch of {toks.shape[0]}: prefix chunks cached "
              f"{cached}{extra}, decoded {n_dec} tokens each")

    t0 = time.time()
    records = run_request_loop(admit_q, batches, prefill_fn=model_prefill,
                               decode_fn=model_decode, on_batch=report)
    admit_q.close()                   # drain barrier before reporting
    dt = time.time() - t0
    s = idx.stats
    print(f"[serve] {served} requests in {dt:.1f}s on {device}; index hit "
          f"rate {idx.hit_rate:.1%}, {s.searches} CAM searches, "
          f"{s.admissions} admissions ({s.admit_calls} device calls), "
          f"{s.throttled} throttles")
    if resume:
        tot = engine.resumed_chunks + engine.computed_chunks
        print(f"[serve] resume: {engine.resumed_chunks}/{tot} prompt chunks "
              f"served from KV slabs "
              f"({idx.slab_store.resident_bytes / 1e6:.2f} MB resident)")
    aq = admit_q.stats
    print(f"[serve] admit queue: {aq.submitted} fps in {aq.batches} batches "
          f"({'inline' if args.sync_admit else 'async'}), "
          f"{aq.rww_flushes} read-your-writes flushes, "
          f"{aq.shed} batches shed, {aq.deferred} submits deferred")
    w = idx.wear_report()
    lt = idx.lifetime_estimate(endurance=args.endurance,
                               ops_per_second=args.ops_per_sec)
    print(f"[serve] wear: installs/set max {w['installs_per_set_max']:.0f} "
          f"(skew {w['skew_max_over_mean']:.2f}x mean), "
          f"{w['rotations']} rotations, "
          f"{w['throttled_sets_now']} sets at window budget; "
          f"projected lifetime {lt.years:.1f}y (ideal {lt.ideal_years:.1f}y)")
    return ServeRun(records=records, batches=batches, index=idx,
                    engine=engine, params=params, cfg=cfg, seconds=dt)


def main(argv=None):
    """CLI entry point: serve and return the request records."""
    return serve(parse_args(argv)).records


if __name__ == "__main__":
    main()
