"""Serving launcher: batched prefill + decode with the MonarchKVIndex prefix
cache (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b \
        --requests 8 --decode-tokens 8 [--reduced] [--device cuda|cpu]

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node N -m repro_torch.launch.serve --mesh host ...

The request loop (:func:`run_request_loop`) is the reference's, line for
line: lookup -> prefill -> submit -> decode, closed- or open-loop.  The
admission queue and the model live on ``--device`` (default ``cuda``;
without a visible card the launcher raises rather than run on the CPU).
The index spreads its ``--n-shards`` set shards over the visible cards as
the reference's spreads them over ``jax.devices()``, so on one card they
co-locate (the unsharded single-launch path); the placement line says
which.

``--mesh`` places the model as the reference's launcher does, over a
``("data", "model")`` mesh with one process per position
(``launch/mesh.py``: ``host`` is ``(world_size, 1)``; ``single`` and
``multi`` raise unless their 256 or 512 processes run; the device and
backend rule of ``init_process``): the parameters by ``param_specs``,
each request's rows over ``data`` and its caches by ``cache_specs``.
Every process holds its own replica of the index, its admission queue
and its slab store, draws the same batches, and runs the same
:func:`run_request_loop`; after every lookup the processes all-reduce
the hit mask's MIN and MAX (:class:`MeshLookups`) and raise if their
replicas disagree, since the next prefill's collectives would then
differ.  The replicas stay equal only if every admission sees the same
t_MWW cycle stamp on every process, since near a set's window budget
the stamps decide throttles and throttles decide installs.  So on a
mesh admission is inline (``--sync-admit`` is implied: the async
worker stamps the op clock wherever its thread happens to run), and
under ``--wear-clock wall`` every replica reads process 0's clock,
broadcast at each lookup (:class:`MeshClock`).  Process 0 prints the
reports.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.dist import sharding
from repro_torch.launch.mesh import device_mesh, get_mesh, init_process
from repro_torch.models import transformer
from repro_torch.serve import step as serve_step
from repro_torch.serve.admit_queue import AdmitQueue
from repro_torch.serve.kv_index import (CHUNK_TOKENS, KVIndexConfig,
                                        KVSlabStore, MonarchKVIndex)
from repro_torch.serve.resume import (PrefillResult, PrefixResumeEngine,
                                      tokens_to_host)


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
                    resume=False, on_logits=None):
    """(prefill_fn, decode_fn, engine) for :func:`run_request_loop`.

    With ``resume=True`` the pair comes from a :class:`PrefixResumeEngine`
    over ``index`` (which must carry a slab store), and ``engine`` is that
    engine; otherwise it is the plain prefill/greedy-decode pair and
    ``engine`` is None.  Either way ``decode_fn`` returns the
    ``(B, decode_tokens)`` greedy tokens, and ``on_logits``, if given,
    sees the logits of every greedy step before its argmax.  Everything
    runs where ``params`` live."""
    device = params["final_ln"].device
    if resume:
        engine = PrefixResumeEngine(params, cfg, max_seq=max_seq,
                                    index=index,
                                    decode_tokens=decode_tokens,
                                    device=device, on_logits=on_logits)
        prefill_fn, decode_fn = engine.request_fns()
        return prefill_fn, decode_fn, engine

    prefill_step = serve_step.make_prefill_step(cfg, max_seq)
    decode_step = serve_step.make_decode_step(cfg, on_logits)

    def model_prefill(toks, hits):
        return prefill_step(params, {"tokens": toks})

    def model_decode(toks, state):
        logits, cache = state
        if on_logits is not None:
            on_logits(logits)
        nxt = serve_step.greedy(logits)
        outs = [nxt]
        for t in range(decode_tokens - 1):
            nxt, logits, cache = decode_step(params, cache, nxt,
                                             toks.shape[1] + t)
            outs.append(nxt)
        return tokens_to_host(torch.cat(outs, dim=1))

    return model_prefill, model_decode, None


class HitsDiverged(RuntimeError):
    """The processes of a mesh answered one lookup differently."""


def check_hits_agree(hits: np.ndarray, device="cpu") -> None:
    """All-reduce the MIN and MAX of a lookup's hit mask over the
    default group (raw collectives on ``device``, the CPU for gloo, the
    card for NCCL) and raise :class:`HitsDiverged` where the processes'
    index replicas answered differently: each process's next prefill
    would then issue other collectives than the others'."""
    dist = torch.distributed
    flat = torch.as_tensor(np.asarray(hits, dtype=np.int32).reshape(-1),
                           device=device)
    lo, hi = flat.clone(), flat.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    apart = int((lo != hi).sum())
    if apart:
        raise HitsDiverged(
            f"process {dist.get_rank()}: {apart} of {flat.numel()} chunk "
            "hits differ across the mesh's index replicas")


class MeshClock:
    """The wall clock of a mesh's index replicas (their ``now_fn``):
    process 0's seconds since the clock was made, as broadcast by the
    last :meth:`tick`.  Every process ticks at the same point of its
    request loop (each lookup), so each replica stamps the same t_MWW
    cycles; between ticks the clock stands still."""

    def __init__(self, device="cpu", time_fn=time.monotonic):
        self.device, self.time_fn = device, time_fn
        self._t0 = time_fn()
        self.t = 0.0

    def now(self) -> float:
        return self.t

    def tick(self) -> None:
        """Set the clock to process 0's reading (a raw broadcast)."""
        t = torch.tensor([self.time_fn() - self._t0], dtype=torch.float64,
                         device=self.device)
        torch.distributed.broadcast(t, src=0)
        self.t = float(t[0])


class MeshLookups:
    """An :class:`AdmitQueue` seen by the request loop of one process of
    a mesh: every lookup ticks the replicas' shared ``clock`` (if any)
    and has its hit mask checked against the other processes'
    (:func:`check_hits_agree`); everything else is the queue's.  A
    ``leader`` (process 0 of the HTTP edge, where requests arrive) first
    sends each batch to the other processes (:func:`send_batch`), whose
    loops run on what they receive.

    Once the hit masks diverged, the mesh has stopped: ``failed`` holds
    the error, ``on_fail(error)`` (if set) was called, and every later
    lookup raises it again at once, with no collective."""

    def __init__(self, queue: AdmitQueue, device="cpu", leader=False,
                 clock: MeshClock | None = None):
        self.queue = queue
        self.device = device
        self.leader = leader
        self.clock = clock
        self.failed: HitsDiverged | None = None
        self.on_fail = None

    def lookup(self, tokens):
        if self.failed is not None:
            raise self.failed
        if self.leader:
            send_batch(tokens, self.device)
        if self.clock is not None:
            self.clock.tick()
        hits = self.queue.lookup(tokens)
        try:
            check_hits_agree(hits, self.device)
        except HitsDiverged as e:
            self.failed = e
            if self.on_fail is not None:
                self.on_fail(e)
            raise
        return hits

    def __getattr__(self, name):
        return getattr(self.queue, name)


def send_batch(tokens: np.ndarray, device="cpu") -> None:
    """Process 0 broadcasts a (B, S) request batch to the mesh: its shape,
    then (B > 0) its tokens, with raw ``dist.broadcast``.  A batch of
    zero rows tells the other processes to stop."""
    toks = np.asarray(tokens, dtype=np.int64)
    torch.distributed.broadcast(
        torch.tensor(toks.shape, dtype=torch.int64, device=device), src=0)
    if toks.shape[0]:
        torch.distributed.broadcast(torch.as_tensor(toks, device=device),
                                    src=0)


def send_keepalive(device="cpu") -> None:
    """Process 0 tells the waiting processes that it is alive and has no
    batch yet (a shape of -1 rows), so that their wait for the next
    batch never outlasts the group's collective timeout."""
    torch.distributed.broadcast(
        torch.tensor([-1, 0], dtype=torch.int64, device=device), src=0)


def receive_batch(device="cpu") -> np.ndarray | None:
    """The batch process 0 sent with :func:`send_batch` (int32; zero rows
    means stop), or None for a :func:`send_keepalive`."""
    shape = torch.empty(2, dtype=torch.int64, device=device)
    torch.distributed.broadcast(shape, src=0)
    b, s = (int(v) for v in shape)
    if b < 0:
        return None
    if b == 0:
        return np.zeros((0, s), np.int32)
    toks = torch.empty((b, s), dtype=torch.int64, device=device)
    torch.distributed.broadcast(toks, src=0)
    return toks.cpu().numpy().astype(np.int32)


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
    rank: int = 0


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Serve batched requests through the Monarch prefix "
                    "index, on one device or over a mesh of processes.")
    ap.add_argument("--arch", default="yi-9b", choices=sorted(configs.ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mesh", default="host",
                    choices=["host", "single", "multi"],
                    help="(data, model) mesh of the torchrun processes: "
                         "host is (world size, 1); single and multi need "
                         "256 and 512 processes")
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
                    help="t_MWW cycle domain: index ops or wall time "
                         "(over a mesh, process 0's, shared)")
    ap.add_argument("--n-shards", type=int, default=1,
                    help="set-axis shards of the index (must divide its 8 "
                         "sets; spread over the visible cards)")
    ap.add_argument("--sync-admit", action="store_true",
                    help="admit inline instead of behind the async "
                         "AdmitQueue (always so over a mesh)")
    ap.add_argument("--max-pending", type=int, default=None,
                    help="bound on fingerprints pending admission")
    ap.add_argument("--admit-policy", default="block",
                    choices=["block", "shed", "defer"],
                    help="back-pressure when --max-pending is hit")
    return ap.parse_args(argv)


def index_placement(idx: MonarchKVIndex) -> str:
    """Where a sharded index lives: co-located on one device (the
    one-launch path), or its partitions and their devices."""
    place = ("co-located, 1 device (collapsed to the unsharded "
             "single-launch path)" if idx.set_mesh is None else
             f"one launch per partition over {idx.n_parts} partitions on "
             + ", ".join(str(d) for d in idx.set_mesh.devices))
    return (f"index sharded over {idx.n_shards} set shards "
            f"({idx.sets_per_shard} sets each; {place})")


@dataclasses.dataclass
class MeshContext:
    """This process's place under ``--mesh`` (``launch/mesh.py``): its
    device and the group's backend, the mesh, its ``DeviceMesh`` (None
    for one process without a group) and its rank."""
    device: torch.device
    backend: str | None
    mesh: object
    dmesh: object
    rank: int

    @property
    def comm_device(self):
        """Where the launcher's own raw collectives run: the card for
        NCCL, else the CPU."""
        return self.device if self.backend == "nccl" else "cpu"


def mesh_context(args: argparse.Namespace, mesh=None) -> MeshContext:
    """This process's :class:`MeshContext`: ``args.mesh``'s mesh, or
    ``mesh`` (a ``launch/mesh.Mesh`` of the world's size) in its place."""
    device, backend = init_process(args.device)
    mesh = get_mesh(args.mesh) if mesh is None else mesh
    dmesh = device_mesh(mesh, device.type)
    rank = torch.distributed.get_rank() if dmesh is not None else 0
    return MeshContext(device, backend, mesh, dmesh, rank)


def replica_clock(ctx: MeshContext, wear_clock: str) -> MeshClock | None:
    """The wall clock the index replicas of a mesh share under
    ``--wear-clock wall``; None off a mesh or under the op clock."""
    if ctx.dmesh is None or wear_clock != "wall":
        return None
    return MeshClock(ctx.comm_device)


def place_params(params: dict, dmesh) -> dict:
    """Parameters placed by ``param_specs`` over ``dmesh`` (as they are
    without one)."""
    if dmesh is None:
        return params
    return sharding.place(params, sharding.param_specs(params, dmesh), dmesh)


def mesh_line(cfg, ctx: MeshContext) -> str:
    """The placement line of a launcher over a mesh."""
    axes = dict(zip(ctx.mesh.axis_names, ctx.mesh.shape))
    return (f"{cfg.name} placed over mesh {axes} ({ctx.mesh.size} "
            f"processes, {ctx.backend}, {ctx.device}): parameters by "
            "param_specs, each request's rows and caches by batch_specs "
            "and cache_specs; an index replica on every process, "
            "admitting inline")


def serve(args: argparse.Namespace, mesh=None, cfg=None,
          on_logits=None) -> ServeRun:
    """Build the index, queue and model from ``args``, serve the
    requests, drain the queue and print the reports (process 0 of a
    mesh).  ``mesh`` replaces ``--mesh``'s (a ``(1, 2)`` model-parallel
    mesh, say); ``cfg`` replaces ``--arch``'s config (one cut in depth,
    say); ``on_logits`` sees every greedy step's logits
    (:func:`build_model_fns`)."""
    ctx = mesh_context(args, mesh)
    device, dmesh, rank = ctx.device, ctx.dmesh, ctx.rank
    say = print if rank == 0 else (lambda *a, **k: None)
    if cfg is None:
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
        say(f"[serve] lifetime target {args.lifetime_years}y @ "
              f"{args.endurance:.0e} endurance -> t_MWW window = "
              f"{kv_cfg.window_ops} {unit}, M={kv_cfg.m_writes}")
    else:
        kv_cfg = KVIndexConfig(n_sets=8, m_writes=args.m_writes,
                               clock=args.wear_clock, n_shards=args.n_shards,
                               fingerprint=fp_scheme)
    clock = replica_clock(ctx, args.wear_clock)
    idx = MonarchKVIndex(kv_cfg, slab_store=KVSlabStore() if resume else None,
                         device=device,
                         now_fn=None if clock is None else clock.now)
    if not resume and not args.no_resume:
        say(f"[serve] resume path off: {cfg.name} has recurrent layers "
              "(prefix hits counted, prefill not skipped)")
    if args.n_shards > 1:
        say(f"[serve] {index_placement(idx)}")
    inline = args.sync_admit or dmesh is not None
    admit_q = AdmitQueue(idx, background=not inline,
                         max_pending=args.max_pending,
                         policy=args.admit_policy)
    loop_q = admit_q
    if dmesh is not None:
        say(f"[serve] {mesh_line(cfg, ctx)}")
        loop_q = MeshLookups(admit_q, ctx.comm_device, clock=clock)

    params = place_params(transformer.init_params(cfg, seed=0,
                                                  device=device), dmesh)
    model_prefill, model_decode, engine = build_model_fns(
        params, cfg, max_seq=max_seq, decode_tokens=args.decode_tokens,
        index=idx, resume=resume, on_logits=on_logits)

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
        say(f"[serve] batch of {toks.shape[0]}: prefix chunks cached "
              f"{cached}{extra}, decoded {n_dec} tokens each")

    t0 = time.time()
    records = run_request_loop(loop_q, batches, prefill_fn=model_prefill,
                               decode_fn=model_decode, on_batch=report)
    admit_q.close()                   # drain barrier before reporting
    dt = time.time() - t0
    s = idx.stats
    say(f"[serve] {served} requests in {dt:.1f}s on {device}; index hit "
          f"rate {idx.hit_rate:.1%}, {s.searches} CAM searches, "
          f"{s.admissions} admissions ({s.admit_calls} device calls), "
          f"{s.throttled} throttles")
    if resume:
        tot = engine.resumed_chunks + engine.computed_chunks
        say(f"[serve] resume: {engine.resumed_chunks}/{tot} prompt chunks "
              f"served from KV slabs "
              f"({idx.slab_store.resident_bytes / 1e6:.2f} MB resident)")
    aq = admit_q.stats
    say(f"[serve] admit queue: {aq.submitted} fps in {aq.batches} batches "
          f"({'inline' if inline else 'async'}), "
          f"{aq.rww_flushes} read-your-writes flushes, "
          f"{aq.shed} batches shed, {aq.deferred} submits deferred")
    w = idx.wear_report()
    lt = idx.lifetime_estimate(endurance=args.endurance,
                               ops_per_second=args.ops_per_sec)
    say(f"[serve] wear: installs/set max {w['installs_per_set_max']:.0f} "
          f"(skew {w['skew_max_over_mean']:.2f}x mean), "
          f"{w['rotations']} rotations, "
          f"{w['throttled_sets_now']} sets at window budget; "
          f"projected lifetime {lt.years:.1f}y (ideal {lt.ideal_years:.1f}y)")
    return ServeRun(records=records, batches=batches, index=idx,
                    engine=engine, params=params, cfg=cfg, seconds=dt,
                    rank=rank)


def main(argv=None):
    """CLI entry point: serve and return the request records."""
    return serve(parse_args(argv)).records


if __name__ == "__main__":
    main()
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
