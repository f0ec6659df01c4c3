"""HTTP serving launcher: the Monarch network edge on one device (port of
``repro/launch/httpd.py``).

    PYTHONPATH=src python -m repro_torch.launch.httpd --arch gemma3-27b \
        --port 8077 --n-workers 2 --decode-tokens 8 [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.httpd --arch yi-9b \
        --reduced --device cpu --port 0          # a CPU smoke

Boots the serving stack — the model on ``--device`` (default ``cuda``;
without a visible card it raises rather than run on the CPU), the
``MonarchKVIndex`` prefix cache (+ KV slab store on resume-capable
archs) and the async ``AdmitQueue`` — behind the stdlib HTTP edge of
:mod:`repro_torch.serve.http_frontend`:

* ``POST /v1/generate`` with ``{"tokens": [[...], ...]}`` decodes
  through the shared index: prefix hits restore KV slabs and resume
  decode exactly as ``launch/serve.py`` does, because both run the same
  ``run_request_loop`` over the same model fns
  (:func:`repro_torch.launch.serve.build_model_fns`).
* ``GET /healthz`` / ``GET /stats`` for probes and operators.
* N router workers micro-batch same-shape requests; the bounded router
  queue answers 429 + ``Retry-After`` under overload; SIGTERM/SIGINT
  triggers the graceful drain (503 on new requests, accepted ones and
  their admissions complete).

Index knobs mirror ``launch/serve.py``; the edge's own are ``--port`` /
``--host``, ``--n-workers``, ``--max-queue``, ``--batch-window-ms``.
``--port 0`` binds an ephemeral port and prints it in the "listening
on" line.  The reference's ``--mesh`` is dropped: the port runs one
device, on which ``--n-shards`` set shards co-locate.
"""
from __future__ import annotations

import argparse
import signal
import threading
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.device import resolve_device
from repro_torch.launch.serve import build_model_fns
from repro_torch.models import transformer
from repro_torch.serve.admit_queue import AdmitQueue
from repro_torch.serve.http_frontend import HttpFrontend, ServeRouter
from repro_torch.serve.kv_index import (KVIndexConfig, KVSlabStore,
                                        MonarchKVIndex)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.httpd",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="yi-9b", choices=sorted(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the model and the index "
                         "(default cuda; cpu only when asked)")
    ap.add_argument("--prompt-len", type=int, default=96,
                    help="max prompt tokens a request may carry (sizes "
                         "the decode cache)")
    ap.add_argument("--decode-tokens", type=int, default=8)
    ap.add_argument("--no-resume", action="store_true")
    # network edge
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8077,
                    help="0 binds an ephemeral port (printed at boot)")
    ap.add_argument("--n-workers", type=int, default=2,
                    help="router serving workers (each runs the shared "
                         "request loop on its micro-batches)")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="router queue bound; a full queue answers 429 "
                         "with Retry-After")
    ap.add_argument("--batch-window-ms", type=float, default=2.0,
                    help="micro-batch window: same-shape requests "
                         "arriving within it share one prefill batch "
                         "(0 disables)")
    ap.add_argument("--verbose", action="store_true",
                    help="per-request access log")
    # index scaling / durability (same semantics as launch/serve.py)
    ap.add_argument("--n-shards", type=int, default=1,
                    help="set-axis shards of the index (must divide its 8 "
                         "sets; co-located on the one device)")
    ap.add_argument("--sync-admit", action="store_true")
    ap.add_argument("--max-pending", type=int, default=None)
    ap.add_argument("--admit-policy", default="block",
                    choices=["block", "shed", "defer"])
    ap.add_argument("--admit-after-reads", type=int, default=1,
                    help="no-allocate filter: offers before install "
                         "(0 = admit on first touch; short-lived smoke "
                         "servers want 0 so repeats hit immediately)")
    ap.add_argument("--wear-clock", default="wall",
                    choices=["ops", "wall"],
                    help="t_MWW cycle domain (the edge defaults to "
                         "'wall': serving traffic is bursty, so the "
                         "admission window should be a real time "
                         "budget)")
    ap.add_argument("--lifetime-years", type=float, default=None)
    ap.add_argument("--endurance", type=float, default=1e8)
    ap.add_argument("--m-writes", type=int, default=3)
    ap.add_argument("--ops-per-sec", type=float, default=1e6)
    return ap


def build_frontend(args, params: dict | None = None
                   ) -> tuple[HttpFrontend, AdmitQueue]:
    """Model + index + router + socket, not yet started.

    ``params`` serves given parameters (on ``args.device``) instead of
    seeded random ones (``transformer.init_params(seed=0)``).  Separated
    from :func:`main` so tests can boot the real stack on an ephemeral
    port and drive it in-process."""
    device = resolve_device(args.device)
    cfg = configs.get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.supports_decode:
        raise SystemExit(f"{cfg.name} is encoder-only; no decode service")
    max_seq = args.prompt_len + args.decode_tokens

    resume = not args.no_resume and transformer.resume_supported(cfg)
    fp_scheme = "prefix" if resume else "block"
    kv_kw = dict(n_sets=8, m_writes=args.m_writes, clock=args.wear_clock,
                 n_shards=args.n_shards, fingerprint=fp_scheme,
                 admit_after_reads=args.admit_after_reads)
    if args.lifetime_years is not None:
        kv_cfg = KVIndexConfig.with_lifetime(
            t_life_years=args.lifetime_years, endurance=args.endurance,
            ops_per_second=args.ops_per_sec, **kv_kw)
    else:
        kv_cfg = KVIndexConfig(**kv_kw)
    idx = MonarchKVIndex(kv_cfg, slab_store=KVSlabStore() if resume else None,
                         device=device)
    admit_q = AdmitQueue(idx, background=not args.sync_admit,
                         max_pending=args.max_pending,
                         policy=args.admit_policy)

    if params is None:
        params = transformer.init_params(cfg, seed=0, device=device)
    prefill_fn, decode_fn, _ = build_model_fns(
        params, cfg, max_seq=max_seq, decode_tokens=args.decode_tokens,
        index=idx, resume=resume)
    # one throwaway prefill before the socket opens, so the first real
    # request does not pay the first calls (kernel loads, allocator)
    warm = np.ones((1, min(args.prompt_len, 16)), np.int32)
    prefill_fn(warm, None if resume else np.zeros((1, 0), bool))
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    router = ServeRouter(
        admit_q, prefill_fn=prefill_fn, decode_fn=decode_fn,
        n_workers=args.n_workers, max_queue=args.max_queue,
        batch_window_s=args.batch_window_ms / 1e3)
    frontend = HttpFrontend(router, host=args.host, port=args.port,
                            verbose=args.verbose)
    print(f"[httpd] {cfg.name} on {device}: resume "
          f"{'ON' if resume else 'off'}, index n_shards={args.n_shards}, "
          f"admit policy={args.admit_policy} "
          f"max_pending={args.max_pending}, wear clock={args.wear_clock}")
    return frontend, admit_q


def main(argv=None):
    args = build_parser().parse_args(argv)
    frontend, admit_q = build_frontend(args)
    frontend.start()
    host, port = frontend.address
    print(f"[httpd] listening on http://{host}:{port} "
          f"({args.n_workers} workers, queue bound {args.max_queue}, "
          f"batch window {args.batch_window_ms:g} ms)", flush=True)

    stop = threading.Event()

    def _graceful(signum, frame):
        print(f"[httpd] signal {signum}: draining "
              "(new requests -> 503)", flush=True)
        # refuse new work IMMEDIATELY; the full drain runs on the main
        # thread below (signal handlers must stay tiny)
        frontend.begin_shutdown()
        stop.set()

    signal.signal(signal.SIGTERM, _graceful)
    signal.signal(signal.SIGINT, _graceful)
    stop.wait()
    t0 = time.monotonic()
    frontend.shutdown()                  # drain router + admissions
    admit_q.close()
    idx = admit_q.index
    r = frontend.router.stats
    print(f"[httpd] drained in {time.monotonic() - t0:.2f}s: "
          f"{r.completed} served / {r.errors} errors / "
          f"{r.rejected_busy} busy-rejected / "
          f"{r.rejected_closed} drain-rejected; "
          f"index hit rate {idx.hit_rate:.1%}, "
          f"{idx.stats.admissions} admissions", flush=True)


if __name__ == "__main__":
    main()
