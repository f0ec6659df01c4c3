"""One run of one cell: set-up, the timed window, the check.

Set-up makes the weights from the seed (``weights.make``), builds the
program's index, admission queue and model functions as its launcher
does (``repro_torch.launch.serve``), offers every document of the mix to
the index as often as the mix says (a warm deployment holds them), and
serves a batch of each of the mix's prompt lengths to warm its shapes
(``Traffic.warm_batches``).  The window then drives
the program's own request loop, ``run_request_loop``, closed: the next
batch goes when the last has returned, until ``seconds`` have passed;
the batches begun by then all finish inside it.

The harness wraps the four calls the loop makes into the program, the
index lookup, the prefill, the admission submit and the decode, each
ending in a device synchronisation where its time is read, under a
profiler range ``pb.<layer>``.  A request's first token is the greedy id
of its prefill logits, copied to the host by the prefill wrapper; its
time to first token runs from the batch's lookup to that copy.

After the window the program's state is freed and its answers are
judged (``check``): every lookup answer against a plain model of the
index replayed over every offer and lookup in order, and the served
tokens of a sample of finished requests against the plain float32
reference of the configuration's architecture.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import time

import numpy as np
import torch

from portbench.lib import trace as trace_mod
from portbench.lib import weights as weights_mod
from portbench.lib.spec import Cell, arch_config
from portbench.lib.traffic import Traffic, torch_seed

clock = time.perf_counter
#: Rows the reference runs at a time, so that its activations stay small.
REFERENCE_ROWS = 4


@dataclasses.dataclass
class Batch:
    """One served batch, host-clock seconds from the window's start."""
    prompts: np.ndarray
    answers: np.ndarray            # each row's answer length, tokens
    start: float = 0.0
    first_token: float = 0.0
    end: float = 0.0
    lookup_s: float = 0.0
    prefill_s: float = 0.0
    submit_s: float = 0.0
    decode_s: float = 0.0
    restored: int = 0              # leading tokens restored, each row
    served: np.ndarray | None = None

    @property
    def rows(self) -> int:
        return int(self.prompts.shape[0])


@dataclasses.dataclass
class Run:
    """What a run measured: the metric readers' one input."""
    cell: Cell
    traffic: Traffic
    setup_s: float
    window_s: float
    batches: list
    counters: dict                 # program counters, window deltas
    lookups: list                  # the window's looked-up token batches
    peak_window_bytes: int | None
    timeline: trace_mod.Timeline | None


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Queue:
    """The admission queue as the request loop sees it: the program's
    queue with its lookup and submit timed and logged."""

    def __init__(self, queue, harness):
        self._q, self._h = queue, harness

    def lookup(self, tokens):
        h = self._h
        t0 = clock()
        b = h.begin(tokens, t0)
        with torch.profiler.record_function("pb.lookup"):
            hits = self._q.lookup(tokens)
            _sync(h.device)
        b.lookup_s = clock() - t0
        h.events.append(("lookup", np.array(tokens), np.array(hits)))
        return hits

    def submit_tokens(self, tokens, slabs=None):
        h = self._h
        t0 = clock()
        with torch.profiler.record_function("pb.submit"):
            ok = (self._q.submit_tokens(tokens) if slabs is None else
                  self._q.submit_tokens(tokens, slabs=slabs))
            _sync(h.device)
        h.cur.submit_s += clock() - t0
        if ok:
            h.events.append(("offer", np.array(tokens)))
        return ok

    def __getattr__(self, name):
        return getattr(self._q, name)


class Harness:
    """Set-up, window and check of one cell under one seed."""

    def __init__(self, cell: Cell, seed: int, device: str = "cuda"):
        from repro_torch.serve.kv_index import CHUNK_TOKENS
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.cfg = arch_config(cell.config)
        geo = cell.config["index"]
        self.traffic = Traffic(cell.traffic, seed, self.cfg.vocab_size,
                               geo["chunk_tokens"])
        if geo["chunk_tokens"] != CHUNK_TOKENS:
            raise ValueError(f"index chunk {geo['chunk_tokens']} tokens, "
                             f"the program's is {CHUNK_TOKENS}")
        self.events: list = []       # offers and lookups, in order
        self.batches: list = []
        self.cur: Batch | None = None
        self.answers = None          # the next batch's answer lengths
        self.t_window = 0.0

    # ----------------------------------------------------------------
    def begin(self, tokens, t0) -> Batch:
        self.cur = Batch(prompts=np.array(tokens), answers=self.answers,
                         start=t0 - self.t_window)
        self.batches.append(self.cur)
        return self.cur

    def _prefill(self, fn):
        from repro_torch.serve.resume import PrefillResult
        chunk = self.cell.config["index"]["chunk_tokens"]

        def prefill(tokens, hits):
            b = self.cur
            t0 = clock()
            with torch.profiler.record_function("pb.prefill"):
                state = fn(tokens, hits)
                resumed = isinstance(state, PrefillResult)
                logits = state.state["logits"] if resumed else state[0]
                # the first tokens reach the host: the time to first token
                torch.argmax(logits, dim=-1).cpu()
                _sync(self.device)
            t1 = clock()
            b.prefill_s = t1 - t0
            b.first_token = t1 - self.t_window
            b.restored = (state.resumed_chunks // b.rows * chunk
                          if resumed else 0)
            return state
        return prefill

    def _decode(self, fn):
        def decode(tokens, state):
            b = self.cur
            t0 = clock()
            with torch.profiler.record_function("pb.decode"):
                served = fn(tokens, state)
                _sync(self.device)
            t1 = clock()
            b.decode_s = t1 - t0
            b.end = t1 - self.t_window
            b.served = np.array(served)
            return served
        return decode

    # ----------------------------------------------------------------
    def setup(self) -> None:
        """Weights, index, queue and model functions; the documents
        offered; a batch of each prompt length served to warm the
        shapes."""
        from repro_torch.launch.serve import build_model_fns
        from repro_torch.models import transformer
        from repro_torch.serve.admit_queue import AdmitQueue
        from repro_torch.serve.kv_index import (KVIndexConfig, KVSlabStore,
                                                MonarchKVIndex)
        c = self.cell.config
        self.resume = bool(c["resume"])
        if self.resume and not transformer.resume_supported(self.cfg):
            raise ValueError(f"{c['name']}: resume on, but the program "
                             "cannot resume this architecture")
        self.weights = weights_mod.make(self.cfg, torch_seed(self.seed),
                                        self.device)
        geo = {k: v for k, v in c["index"].items() if k != "chunk_tokens"}
        self.index = MonarchKVIndex(
            KVIndexConfig(**geo),
            slab_store=KVSlabStore() if self.resume else None,
            device=self.device)
        self.queue = AdmitQueue(self.index, **c["queue"])
        prefill, decode, self.engine = build_model_fns(
            self.weights, self.cfg, max_seq=self.traffic.max_seq,
            decode_tokens=self.traffic.decode_tokens, index=self.index,
            resume=self.resume)
        self.prefill_fn = self._prefill(prefill)
        self.decode_fn = self._decode(decode)
        self.loop_queue = _Queue(self.queue, self)
        self._fill()
        # every shape, and the allocator's steady state, in which the
        # longest prefill runs while the last batch's state is still held
        self._serve(self.traffic.warm_batches())
        self.queue.flush()
        self.batches = []
        _sync(self.device)

    def _fill(self) -> None:
        """Offer every document ``fill_touches`` times; the last offer
        carries the documents' KV slabs where the program resumes."""
        touches = int(self.cell.traffic.get("fill_touches", 0))
        for t in range(touches):
            for docs in self.traffic.fill_batches():
                slabs = None
                if self.resume and t == touches - 1:
                    slabs = self.engine.prefill(docs, None).slabs
                ok = (self.queue.submit_tokens(docs) if slabs is None else
                      self.queue.submit_tokens(docs, slabs=slabs))
                if ok:
                    self.events.append(("offer", np.array(docs)))
                del slabs
            self.queue.flush()

    def _serve(self, batches):
        """The program's request loop over ``batches`` ((tokens,
        answer lengths) pairs)."""
        from repro_torch.launch.serve import run_request_loop

        def tokens():
            for toks, self.answers in batches:
                yield toks
        return run_request_loop(self.loop_queue, tokens(),
                                prefill_fn=self.prefill_fn,
                                decode_fn=self.decode_fn, now_fn=clock)

    # ----------------------------------------------------------------
    def _counters(self) -> dict:
        out = {f"index.{k}": v for k, v in
               dataclasses.asdict(self.index.stats).items()}
        out.update({f"queue.{k}": v for k, v in
                    dataclasses.asdict(self.queue.stats).items()})
        if self.engine is not None:
            out["engine.resumed_chunks"] = self.engine.resumed_chunks
            out["engine.computed_chunks"] = self.engine.computed_chunks
        return out

    def window(self, seconds: float, traced: bool, setup_s: float) -> Run:
        """Serve until ``seconds`` have passed; the batches begun by then
        finish inside the window."""
        cuda = self.device.type == "cuda"
        gc.collect()
        gc.freeze()
        if cuda:
            self.setup_peak = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        before = self._counters()
        n_events = len(self.events)

        def batches():
            i = 0
            while clock() - self.t_window < seconds:
                yield self.traffic.batch(i)
                i += 1

        prof = None
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        with torch.profiler.record_function(trace_mod.WINDOW):
            self.t_window = clock()
            self._serve(batches())
            _sync(self.device)
            window_s = clock() - self.t_window
        timeline = None
        if prof is not None:
            prof.__exit__(None, None, None)
            timeline = trace_mod.read(prof.profiler.kineto_results.events())
            del prof
        self.peak_window = (torch.cuda.max_memory_allocated(self.device)
                            if cuda else None)
        after = self._counters()
        gc.unfreeze()
        return Run(
            cell=self.cell, traffic=self.traffic, setup_s=setup_s,
            window_s=window_s, batches=list(self.batches),
            counters={k: after[k] - before[k] for k in after},
            lookups=[e[1] for e in self.events[n_events:]
                     if e[0] == "lookup"],
            peak_window_bytes=self.peak_window, timeline=timeline)

    def memory_peak(self) -> int:
        """The process's device peak up to the window's close."""
        if self.device.type != "cuda":
            return 0
        return int(max(self.setup_peak, self.peak_window))

    # ----------------------------------------------------------------
    def release(self) -> None:
        """Stop the admission worker and free the program's state; the
        weights stay for the reference."""
        self.queue.close()
        for name in ("queue", "loop_queue", "index", "engine", "prefill_fn",
                     "decode_fn"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, run: Run) -> dict:
        """The numbers compared, each ``{"value", "limit"}``: lookup
        answers unlike the plain index model's, and the widest gap by
        which a sampled served token's reference logit lies below the
        reference's best."""
        from portbench.reference import index as plain_index
        limits = self.cell.limits
        bad, total = plain_index.mismatches(self.cell.config["index"],
                                            self.events)
        if not total:
            raise RuntimeError("no lookup answer to compare")
        gap, _ = self.gaps(run)
        return {
            "hit_mismatch": {"value": bad, "limit": limits["hit_mismatch"]},
            "max_gap": {"value": gap, "limit": limits["max_gap"]},
        }

    def sampled(self, run: Run) -> list:
        """The sampled finished requests as (tokens (R, S), served
        (R, T)) groups of one prompt length: each prompt followed by its
        served tokens but the last."""
        rows = [(b, r) for b in run.batches if b.served is not None
                for r in range(b.rows)]
        pick = self.traffic.sample([b.prompts.shape[1] for b, _ in rows])
        groups: dict = {}
        for i in pick:
            b, r = rows[i]
            toks, served = groups.setdefault(b.prompts.shape[1], ([], []))
            toks.append(np.concatenate([b.prompts[r], b.served[r, :-1]]))
            served.append(b.served[r])
        return [(np.stack(t), np.stack(s)) for t, s in groups.values()]

    def gaps(self, run: Run, control: bool = False):
        """(program, control) widest gaps over the sampled requests: by
        how much the reference logit of each served token lies below the
        reference's best; with ``control``, also that of the token the
        fp8 reference puts first at each of those positions (else None).
        """
        ref = importlib.import_module(
            f"portbench.reference.{self.cell.config['reference']}")
        worst = [0.0, 0.0]
        for toks, served in self.sampled(run):
            first_out = toks.shape[1] - served.shape[1]
            for lo in range(0, len(toks), REFERENCE_ROWS):
                t = torch.as_tensor(toks[lo:lo + REFERENCE_ROWS],
                                    device=self.device).long()
                picks = [torch.as_tensor(served[lo:lo + REFERENCE_ROWS],
                                         device=self.device).long()]
                ref_logits = ref.logits(self.weights, self.cell.config, t,
                                        first_out)
                if control:
                    picks.append(ref.logits(self.weights, self.cell.config,
                                            t, first_out, "fp8").argmax(-1))
                best = ref_logits.max(-1).values
                for k, pick in enumerate(picks):
                    got = ref_logits.gather(-1, pick[..., None])[..., 0]
                    worst[k] = max(worst[k], float((best - got).max()))
                del ref_logits
        return worst[0], (worst[1] if control else None)
