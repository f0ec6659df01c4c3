"""Wear-leveling and t_MWW enforcement (paper §8, Fig. 8) — port of
``repro/core/wear.py`` over torch tensors.

Pure-functional state machine: every function returns a new
:class:`WearState` and never writes into its argument, so the serving
index can hold one state per partition and the tests can replay a trace
step for step against the JAX reference.

The cycle domain is int32 throughout, exactly as in the reference: every
per-superset stamp, counter and window field is an int32 tensor, and
every operand is cast to int32 before it meets one (an int64 operand
would widen silently and change the wrap and rebase behaviour).

A state may carry a leading lane axis ``G`` (the batched simulator's:
``(G, S)`` rows, ``(G,)`` counters and offsets, built by
``init_state(cfg, device, lanes=G)``).  :func:`is_locked` and
:func:`record_write` then take ``(G,)`` supersets, flags and cycles and
``cfg`` fields that are scalars or ``(G,)`` tensors, through the same
code that serves the single state.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import geometry, lanes
from repro_torch.core.timing import CPU_HZ, t_mww_seconds
from repro_torch.device import resolve_device

#: Cycle resolution of the ``clock="wall"`` domain: one cycle per
#: microsecond of host wall time (the rebase below folds the clock every
#: ~17.9 wall-minutes, which also bounds the longest expressible window).
WALL_HZ = 1_000_000

#: Legal values of the ``clock`` knob.
CLOCKS = ("ops", "wall")

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class WearConfig:
    n_supersets: int
    m_writes: int = 3
    dc_limit: int = 8192
    wc_limit: int = 1 << 22
    wr_shift: int = 9
    t_mww_cycles: int = 0
    blocks_per_superset: int = 512
    #: Cycle domain the caller stamps in: ``"ops"`` (op-counter proxy) or
    #: ``"wall"`` (wall microseconds).  The predicates are clock-agnostic
    #: int32 difference arithmetic.
    clock: str = "ops"

    def __post_init__(self):
        if self.clock not in CLOCKS:
            raise ValueError(
                f"WearConfig.clock={self.clock!r}: expected one of {CLOCKS}")

    @property
    def window_write_budget(self) -> int:
        # M writes per BLOCK per window, tracked at superset granularity.
        return self.blocks_per_superset * self.m_writes


def make_config(n_supersets: int, m_writes: int = 3,
                t_life_years: float = 10.0, endurance: float = 1e8,
                clock: str = "ops", **kw) -> WearConfig:
    """WearConfig with the t_MWW window derived from a lifetime target:
    ``t_MWW_seconds * CPU_HZ`` cycles for ``clock="ops"`` (the CPU-cycle
    proxy), ``t_MWW_seconds * WALL_HZ`` for ``clock="wall"``."""
    t_mww_s = t_mww_seconds(m_writes, t_life_years * 365.25 * 24 * 3600,
                            endurance)
    hz = CPU_HZ if clock == "ops" else WALL_HZ
    return WearConfig(
        n_supersets=n_supersets, m_writes=m_writes,
        t_mww_cycles=int(t_mww_s * hz), clock=clock, **kw,
    )


@dataclasses.dataclass(frozen=True)
class WearDyn:
    """Wear knobs as int32 scalar tensors on the state's device; field
    names mirror the ``WearConfig`` attributes the predicates read, so
    either can be passed as ``cfg``."""
    window_write_budget: torch.Tensor
    dc_limit: torch.Tensor
    wc_limit: torch.Tensor
    wr_shift: torch.Tensor
    t_mww_cycles: torch.Tensor


def dyn_of(cfg: WearConfig, device: str | torch.device = "cuda") -> WearDyn:
    device = resolve_device(device)
    i32 = lambda v: torch.tensor(v, dtype=_I32, device=device)
    return WearDyn(
        window_write_budget=i32(cfg.window_write_budget),
        dc_limit=i32(cfg.dc_limit), wc_limit=i32(cfg.wc_limit),
        wr_shift=i32(cfg.wr_shift), t_mww_cycles=i32(cfg.t_mww_cycles),
    )


@dataclasses.dataclass(frozen=True)
class WearState:
    swt_w: torch.Tensor          # (S,) int8 — written flag
    swt_d: torch.Tensor          # (S,) int8 — dirty flag
    write_counter: torch.Tensor  # scalar int32
    superset_counter: torch.Tensor
    dirty_counter: torch.Tensor
    offsets: geometry.RotaryOffsets
    # t_MWW window tracking, per superset.
    window_writes: torch.Tensor  # (S,) int32 writes in current window
    window_start: torch.Tensor   # (S,) int32 cycle the window opened
    locked_until: torch.Tensor   # (S,) int32 cycle until which it is locked
    total_rotates: torch.Tensor  # scalar int32
    total_flushed: torch.Tensor  # scalar int32 — dirty supersets flushed


def init_state(cfg: WearConfig, device: str | torch.device = "cuda",
               lanes: int | None = None) -> WearState:
    """Fresh state; ``lanes=G`` gives every field a leading lane axis."""
    device = resolve_device(device)
    g = () if lanes is None else (lanes,)
    s = g + (cfg.n_supersets,)
    z = lambda shape, dt=_I32: torch.zeros(shape, dtype=dt, device=device)
    return WearState(
        swt_w=z(s, torch.int8), swt_d=z(s, torch.int8),
        write_counter=z(g), superset_counter=z(g), dirty_counter=z(g),
        offsets=geometry.zero_offsets(device, lanes),
        window_writes=z(s), window_start=z(s), locked_until=z(s),
        total_rotates=z(g), total_flushed=z(g),
    )


def _i32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, device=like.device).to(_I32)


def msb_index(x) -> torch.Tensor:
    """Index of the most-significant non-zero bit of ``x`` read as uint32;
    -1 for zero.  Exact for every int32 input (negatives read as their
    uint32 bit pattern, so their MSB is 31) — the reference's
    ``31 - clz(uint32(x))`` without a clz primitive."""
    u = torch.as_tensor(x).to(torch.int64) & 0xFFFFFFFF
    # float64 holds every uint32 exactly: x = m * 2**e with m in [0.5, 1),
    # so the MSB is e - 1 (and frexp(0) gives e = 0, hence -1).
    return (torch.frexp(u.to(torch.float64)).exponent - 1).to(_I32)


def wr_signal(state: WearState, cfg) -> torch.Tensor:
    """WR=1 when msb(write_counter) - msb(superset_counter) >= wr_shift
    (the divider-free 512x ratio detector, Fig. 8)."""
    wmsb = msb_index(state.write_counter)
    smsb = msb_index(state.superset_counter)
    return (((wmsb - smsb) >= _i32(cfg.wr_shift, wmsb))
            & (state.superset_counter > 0))


def rotate_signal(state: WearState, cfg) -> torch.Tensor:
    wc = state.write_counter >= _i32(cfg.wc_limit, state.write_counter)
    dc = state.dirty_counter >= _i32(cfg.dc_limit, state.dirty_counter)
    return wr_signal(state, cfg) | wc | dc


def _rows(state: WearState, superset) -> tuple:
    """Index of ``superset``'s row in the per-superset fields (prefixed
    with the lane index for a lane-batched state)."""
    return lanes.index(state.locked_until, 1, superset)


def is_locked(state: WearState, superset, cycle) -> torch.Tensor:
    return (_i32(cycle, state.locked_until)
            < state.locked_until[_rows(state, superset)])


def _window_now(state: WearState, cfg, superset, cycle):
    """THE t_MWW window-rollover arithmetic (shared by ``record_write``,
    ``record_write_rows`` and ``window_would_exceed``): returns
    ``(win, expired, writes_now)`` for ``superset`` at ``cycle``.  Only
    int32 differences of ``cycle`` against stored stamps are compared."""
    win = torch.clamp(_i32(cfg.t_mww_cycles, state.window_start), min=1)
    expired = (cycle - state.window_start[superset]) >= win
    writes_now = torch.where(expired, torch.zeros_like(cycle),
                             state.window_writes[superset])
    return win, expired, writes_now


def window_would_exceed(state: WearState, cfg, superset,
                        cycle) -> torch.Tensor:
    """Reject-before-write t_MWW predicate (§6.2 lifetime throttle): True
    where ONE more write at ``cycle`` would exceed the window budget of
    ``superset`` (scalar or (N,))."""
    s = torch.as_tensor(superset, device=state.window_start.device).long()
    cycle = _i32(cycle, state.window_start)
    _, _, writes_now = _window_now(state, cfg, s, cycle)
    return (writes_now + 1) > _i32(cfg.window_write_budget, writes_now)


def record_write(state: WearState, cfg, superset, makes_dirty, cycle):
    """Account one XAM write to ``superset`` at ``cycle``.

    Returns ``(new_state, rotated, flushed)``.  Handles, in order: t_MWW
    window rollover, budget accounting + lock, SWT/counter updates,
    rotate detection + offset bump + SWT reset (the reference's
    ``lax.cond`` becomes a ``torch.where`` over every field).  Over a
    lane-batched state every operand is ``(G,)`` and so are ``rotated``
    and ``flushed``: ``jax.vmap`` of the reference's function."""
    dev = state.window_start.device
    s = _rows(state, superset)
    cycle = _i32(cycle, state.window_start)
    dirty = torch.as_tensor(makes_dirty, device=dev).to(torch.bool)

    win, expired, w_writes = _window_now(state, cfg, s, cycle)
    w_start = torch.where(expired, cycle, state.window_start[s])
    w_writes = w_writes + 1
    over = w_writes > _i32(cfg.window_write_budget, w_writes)
    locked_until = torch.where(over, w_start + win, state.locked_until[s])

    window_writes = lanes.put(state.window_writes, s, w_writes)
    window_start = lanes.put(state.window_start, s, w_start)
    locked = lanes.put(state.locked_until, s, locked_until)

    first_write = state.swt_w[s] == 0
    superset_counter = state.superset_counter + first_write.to(_I32)
    swt_w = lanes.put(state.swt_w, s, 1)
    newly_dirty = (state.swt_d[s] == 0) & dirty
    dirty_counter = state.dirty_counter + newly_dirty.to(_I32)
    swt_d = lanes.put(state.swt_d, s,
                      torch.maximum(state.swt_d[s], dirty.to(torch.int8)))
    write_counter = state.write_counter + 1

    mid = WearState(
        swt_w=swt_w, swt_d=swt_d,
        write_counter=write_counter, superset_counter=superset_counter,
        dirty_counter=dirty_counter, offsets=state.offsets,
        window_writes=window_writes, window_start=window_start,
        locked_until=locked,
        total_rotates=state.total_rotates, total_flushed=state.total_flushed,
    )
    rot = rotate_signal(mid, cfg)
    flushed = torch.where(rot, swt_d.to(_I32).sum(-1), 0).to(_I32)

    zero = lambda x: torch.where(lanes.bcast(rot, x), 0, x)
    new_state = WearState(
        swt_w=zero(swt_w), swt_d=zero(swt_d),
        write_counter=zero(write_counter),
        superset_counter=zero(superset_counter),
        dirty_counter=zero(dirty_counter),
        offsets=lanes.pick(rot, geometry.apply_rotate(mid.offsets),
                           mid.offsets),
        window_writes=window_writes, window_start=window_start,
        locked_until=locked,
        total_rotates=torch.where(rot, mid.total_rotates + 1,
                                  mid.total_rotates),
        total_flushed=(mid.total_flushed + flushed).to(_I32),
    )
    return new_state, rot, flushed


def record_writes(state: WearState, cfg, supersets, makes_dirty, cycles,
                  active=None):
    """Batched :func:`record_write`: apply a trace of writes in order.

    ``supersets``/``cycles`` (B,) int32, ``makes_dirty`` (B,) bool,
    ``active`` (B,) bool masking padding lanes (None = all active).
    Returns ``(state, rotated (B,) bool, flushed (B,) int32)``, equal to
    the reference's ``lax.scan`` step for step.  An inactive lane changes
    neither the state nor its outputs, so the loop skips it (``active`` is
    read on the host) instead of computing and discarding it."""
    dev = state.window_start.device
    s = torch.as_tensor(supersets, device=dev).to(_I32)
    d = torch.as_tensor(makes_dirty, device=dev).to(torch.bool)
    c = torch.as_tensor(cycles, device=dev).to(_I32)
    n = s.shape[0]
    act = ([True] * n if active is None else
           torch.as_tensor(active).to(torch.bool).cpu().tolist())
    no_rot = torch.zeros((), dtype=torch.bool, device=dev)
    no_fl = torch.zeros((), dtype=_I32, device=dev)
    rots, fls = [no_rot] * n, [no_fl] * n
    for i in range(n):
        if act[i]:
            state, rots[i], fls[i] = record_write(state, cfg, s[i], d[i],
                                                  c[i])
    if n == 0:
        return state, no_rot.new_zeros(0), no_fl.new_zeros(0)
    return state, torch.stack(rots), torch.stack(fls)


def _scatter_rows(field: torch.Tensor, idx: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``field.at[idx].set(vals, mode="drop")``: lanes whose ``idx`` is
    ``len(field)`` land in a scratch row that is cut off again, so
    inactive lanes write nothing and never collide with active ones."""
    buf = torch.cat([field, field.new_zeros((1,) + field.shape[1:])])
    buf[idx] = vals.to(field.dtype)
    return buf[:field.shape[0]]


def record_write_rows(state: WearState, cfg, supersets, cycles, active,
                      makes_dirty=None) -> WearState:
    """Vectorized :func:`record_write` over DISTINCT supersets — one
    parallel row update instead of a scan.

    Bit-identical to folding :func:`record_write` over the lanes in any
    order, provided the active supersets are pairwise distinct and the
    rotate signals are disabled (``wr_shift >= 32``, huge WC/DC limits —
    the serving index's configuration): offsets, ``total_rotates`` and
    ``total_flushed`` then pass through untouched.  Inactive lanes are
    full no-ops.

    >>> import torch
    >>> cfg = WearConfig(n_supersets=4, t_mww_cycles=100,
    ...                  blocks_per_superset=2, wr_shift=32)
    >>> st = record_write_rows(
    ...     init_state(cfg, device="cpu"), cfg, torch.tensor([0, 2, 1]),
    ...     torch.tensor([5, 6, 7]), torch.tensor([True, True, False]))
    >>> st.window_writes.tolist(), int(st.write_counter)
    ([1, 0, 1, 0], 2)
    """
    dev = state.window_start.device
    s = torch.as_tensor(supersets, device=dev).long()
    cycle = _i32(cycles, state.window_start)
    act = torch.as_tensor(active, device=dev).to(torch.bool)
    dirty = (torch.ones_like(act) if makes_dirty is None
             else torch.as_tensor(makes_dirty, device=dev).to(torch.bool))
    n = state.swt_w.shape[0]
    sc = torch.clamp(s, 0, n - 1)                   # gather-safe row index
    ii = torch.where(act, sc, torch.full_like(sc, n))   # drop when inactive

    win, expired, w_writes = _window_now(state, cfg, sc, cycle)
    w_start = torch.where(expired, cycle, state.window_start[sc])
    w_writes = w_writes + 1
    over = w_writes > _i32(cfg.window_write_budget, w_writes)
    locked_until = torch.where(over, w_start + win, state.locked_until[sc])

    window_writes = _scatter_rows(state.window_writes, ii, w_writes)
    window_start = _scatter_rows(state.window_start, ii, w_start)
    locked = _scatter_rows(state.locked_until, ii, locked_until)

    first_write = (state.swt_w[sc] == 0) & act
    superset_counter = (state.superset_counter
                        + first_write.to(_I32).sum().to(_I32))
    swt_w = _scatter_rows(state.swt_w, ii, torch.ones_like(sc))
    newly_dirty = (state.swt_d[sc] == 0) & dirty & act
    dirty_counter = (state.dirty_counter
                     + newly_dirty.to(_I32).sum().to(_I32))
    swt_d = _scatter_rows(
        state.swt_d, ii,
        torch.maximum(state.swt_d[sc], dirty.to(torch.int8)))
    write_counter = state.write_counter + act.to(_I32).sum().to(_I32)

    return WearState(
        swt_w=swt_w, swt_d=swt_d,
        write_counter=write_counter, superset_counter=superset_counter,
        dirty_counter=dirty_counter, offsets=state.offsets,
        window_writes=window_writes, window_start=window_start,
        locked_until=locked,
        total_rotates=state.total_rotates, total_flushed=state.total_flushed,
    )


def shard_states(cfg: WearConfig, n_shards: int,
                 device: str | torch.device = "cuda") -> list[WearState]:
    """Per-shard wear states, each over ``n_supersets // n_shards``
    contiguous supersets (the serving index uses one partition)."""
    if n_shards < 1 or cfg.n_supersets % n_shards != 0:
        raise ValueError(
            f"n_shards={n_shards} must divide n_supersets={cfg.n_supersets}")
    sub = dataclasses.replace(cfg, n_supersets=cfg.n_supersets // n_shards)
    return [init_state(sub, device) for _ in range(n_shards)]


def concat_states(states: list[WearState]) -> WearState:
    """Global read-only view over per-shard wear states: per-superset
    fields concatenated in shard order, scalar counters summed, offsets
    from shard 0.  Reporting only."""
    if len(states) == 1:
        return states[0]
    cat = lambda f: torch.cat([getattr(s, f) for s in states])
    tot = lambda f: sum(getattr(s, f) for s in states).to(_I32)
    return WearState(
        swt_w=cat("swt_w"), swt_d=cat("swt_d"),
        write_counter=tot("write_counter"),
        superset_counter=tot("superset_counter"),
        dirty_counter=tot("dirty_counter"),
        offsets=states[0].offsets,
        window_writes=cat("window_writes"),
        window_start=cat("window_start"),
        locked_until=cat("locked_until"),
        total_rotates=tot("total_rotates"),
        total_flushed=tot("total_flushed"),
    )


#: Serving clock re-base threshold: the int32 cycle domain is folded back
#: by this much before it wraps.  Every window comparison is
#: difference-based, so shifting the clock and every stored stamp by the
#: same delta changes no decision.
CLOCK_REBASE_AT = 1 << 30


def maybe_rebase(state: WearState, op_counter: int):
    """Fold ``op_counter`` (and the state's stamps, via
    :func:`rebase_clock`) once it reaches CLOCK_REBASE_AT.  Returns
    ``(state, op_counter)``."""
    if op_counter >= CLOCK_REBASE_AT:
        state = rebase_clock(state, CLOCK_REBASE_AT)
        op_counter -= CLOCK_REBASE_AT
    return state, op_counter


def rebase_clock(state: WearState, delta) -> WearState:
    """Shift all stored timestamps down by ``delta`` (callers shift their
    clock in lockstep), floored at -CLOCK_REBASE_AT so repeated rebases
    cannot underflow int32."""
    d = _i32(delta, state.window_start)
    floor = -CLOCK_REBASE_AT
    return dataclasses.replace(
        state,
        window_start=torch.clamp(state.window_start - d, min=floor),
        locked_until=torch.clamp(state.locked_until - d, min=floor),
    )


def install_decision(dirty: torch.Tensor, read: torch.Tensor):
    """Fate of an L3-evicted block from its D (dirty) / R (read) flags:
    ``(install_in_monarch, forward_to_dram)`` — read blocks install,
    dirty-never-read blocks are forwarded, clean-never-read blocks drop.

    >>> import torch
    >>> inst, fwd = install_decision(torch.tensor([1, 1, 0, 0]),
    ...                              torch.tensor([1, 0, 1, 0]))
    >>> inst.tolist(), fwd.tolist()
    ([True, False, True, False], [False, True, False, False])
    """
    dirty = dirty.to(torch.bool)
    read = read.to(torch.bool)
    return read, dirty & ~read
