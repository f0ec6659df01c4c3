"""Monarch vault controllers (paper §7, Fig. 5/6/7) — port of
``repro/core/controller.py`` over torch tensors.

Two of the paper's control modes are modelled here:

* ``flat-CAM`` — software associative scratchpad: data write, key/mask
  write (RowIn CAM, odd row -> mask, even row -> key), search (read of
  the match pointer) and data read.  Key/mask live in global vault
  registers and are pushed to supersets lazily; a search is elided when
  the match register already holds a fresh result.
* ``cache`` — hardware-managed 512-way set-associative cache: CAM banks
  hold tags, RAM banks hold data, with counter-ordered replacement.

The controllers are explicit-state step functions: every request returns
the new state and the interface commands (P/A/R/W/S) it issued.

Bank modes: RAM=0, CAM=1 (prepare toggles).  Superset datapath: RowIn=0,
ColumnIn=1 (activate toggles).  Every bank starts in RAM / RowIn.

The cache-mode state may carry a leading lane axis ``G`` (the batched
simulator's): ``(G, n_sets, ways)`` planes, a ``(G,)`` counter, and
``(G,)`` set ids, tags and flags, through the same code as one state.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import lanes, wear, xam
from repro_torch.device import resolve_device

RAM, CAM = 0, 1
ROW_IN, COL_IN = 0, 1

_I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class CommandCounts:
    """Interface commands issued while serving one request."""
    prepares: torch.Tensor
    activates: torch.Tensor
    reads: torch.Tensor
    writes: torch.Tensor
    searches: torch.Tensor

    @staticmethod
    def zero(device: str | torch.device = "cuda") -> "CommandCounts":
        return _count(resolve_device(device))

    def __add__(self, o: "CommandCounts") -> "CommandCounts":
        return CommandCounts(
            self.prepares + o.prepares, self.activates + o.activates,
            self.reads + o.reads, self.writes + o.writes,
            self.searches + o.searches,
        )


def _count(device, prepares=0, activates=0, reads=0, writes=0,
           searches=0) -> CommandCounts:
    a = lambda v: torch.as_tensor(v, device=device).to(_I32)
    return CommandCounts(a(prepares), a(activates), a(reads), a(writes),
                         a(searches))


# ===========================================================================
# flat-CAM controller over one superset's worth of sets.
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class FlatCamState:
    """One vault's flat-CAM control state plus the XAM contents of a
    superset (8 sets x 64 rows x 512 cols logical planes)."""
    sets_bits: torch.Tensor       # (n_sets, 64, 512) int8 — XAM planes
    key_reg: torch.Tensor         # (64,) int8 — global key register
    mask_reg: torch.Tensor        # (64,) int8 — global mask register
    match_reg: torch.Tensor       # scalar int32 — match pointer (-1 = NULL)
    match_fresh: torch.Tensor     # scalar bool — result valid for key/mask
    superset_has_latest_km: torch.Tensor  # scalar bool — key/mask pushed
    bank_mode: torch.Tensor       # scalar int32 RAM/CAM
    datapath: torch.Tensor        # scalar int32 RowIn/ColumnIn


def init_flat_cam(n_sets: int = 8, rows: int = 64, cols: int = 512,
                  device: str | torch.device = "cuda") -> FlatCamState:
    dev = resolve_device(device)
    scalar = lambda v, dt: torch.tensor(v, dtype=dt, device=dev)
    return FlatCamState(
        sets_bits=torch.zeros((n_sets, rows, cols), dtype=torch.int8,
                              device=dev),
        key_reg=torch.zeros((rows,), dtype=torch.int8, device=dev),
        mask_reg=torch.ones((rows,), dtype=torch.int8, device=dev),
        match_reg=scalar(-1, _I32),
        match_fresh=scalar(False, torch.bool),
        superset_has_latest_km=scalar(False, torch.bool),
        bank_mode=scalar(RAM, _I32),
        datapath=scalar(ROW_IN, _I32),
    )


def _flag(state: FlatCamState, v: bool) -> torch.Tensor:
    return torch.tensor(v, device=state.sets_bits.device)


def _transition(state: FlatCamState, want_mode: int, want_path: int):
    """Issue prepare/activate as needed to reach (mode, datapath)."""
    p = (state.bank_mode != want_mode).to(_I32)
    a = (state.datapath != want_path).to(_I32)
    st = dataclasses.replace(
        state,
        bank_mode=torch.full_like(state.bank_mode, want_mode),
        datapath=torch.full_like(state.datapath, want_path),
    )
    return st, _count(state.sets_bits.device, prepares=p, activates=a)


def cam_data_write(state: FlatCamState, set_id, col,
                   key_bits) -> tuple[FlatCamState, CommandCounts]:
    """Store a key down a column of a set (ColumnIn CAM, §7)."""
    state, c0 = _transition(state, CAM, COL_IN)
    bits = state.sets_bits
    dev = bits.device
    s = torch.as_tensor(set_id, device=dev).long()
    col_onehot = torch.arange(bits.shape[2], device=dev) == torch.as_tensor(
        col, device=dev)
    key = torch.as_tensor(key_bits, device=dev).to(torch.int8)
    new_plane = torch.where(col_onehot[None, :], key[:, None], bits[s])
    st = dataclasses.replace(state, sets_bits=lanes.put(bits, (s,), new_plane),
                             match_fresh=_flag(state, False))
    return st, c0 + _count(dev, writes=1)


def key_mask_write(state: FlatCamState, row_addr,
                   value_bits) -> tuple[FlatCamState, CommandCounts]:
    """Software write to the key/mask pointers.  RowIn CAM mode: even row
    address -> key register, odd -> mask register (§6.2)."""
    state, c0 = _transition(state, CAM, ROW_IN)
    dev = state.sets_bits.device
    is_mask = (torch.as_tensor(row_addr, device=dev) % 2).to(torch.bool)
    value = torch.as_tensor(value_bits, device=dev).to(torch.int8)
    st = dataclasses.replace(
        state,
        key_reg=torch.where(is_mask, state.key_reg, value),
        mask_reg=torch.where(is_mask, value, state.mask_reg),
        match_fresh=_flag(state, False),
        superset_has_latest_km=_flag(state, False),
    )
    return st, c0 + _count(dev, writes=1)


def search_read(state: FlatCamState,
                set_id) -> tuple[FlatCamState, torch.Tensor, CommandCounts]:
    """Software read of the match pointer: pushes key/mask and searches
    only when the match register does not hold a fresh result (§7).  The
    reference's ``lax.cond`` becomes a ``torch.where`` over every field of
    the stale path's result."""
    dev = state.sets_bits.device
    km_writes = torch.where(state.superset_has_latest_km, 0, 1)
    st, c_t = _transition(state, CAM, COL_IN)
    plane = st.sets_bits[torch.as_tensor(set_id, device=dev).long()]
    arr = xam.XamArray(plane, torch.zeros_like(plane, dtype=_I32))
    _, idx = xam.set_search(arr, st.key_reg, st.mask_reg)
    stale = dataclasses.replace(
        st, match_reg=idx.to(_I32), match_fresh=_flag(state, True),
        superset_has_latest_km=_flag(state, True))
    stale_counts = c_t + _count(dev, searches=1, writes=km_writes)
    fresh = state.match_fresh
    return (lanes.pick(fresh, state, stale),
            torch.where(fresh, state.match_reg, idx.to(_I32)),
            lanes.pick(fresh, CommandCounts.zero(dev), stale_counts))


def cam_data_write_tracked(state: FlatCamState, wstate: wear.WearState,
                           wcfg, set_id, col, key_bits, superset, cycle):
    """flat-CAM data write with §8 wear accounting fused in: the write
    command the controller charges is the same event ``wear.record_write``
    records.  Returns ``(state, wstate, rotated, counts)``."""
    state, counts = cam_data_write(state, set_id, col, key_bits)
    wstate, rotated, _flushed = wear.record_write(
        wstate, wcfg, superset, True, cycle)
    return state, wstate, rotated, counts


def cam_row_read(state: FlatCamState, set_id,
                 row) -> tuple[FlatCamState, torch.Tensor, CommandCounts]:
    """Read stored keys back out (footnote 1: row-mode read)."""
    state, c0 = _transition(state, CAM, ROW_IN)
    dev = state.sets_bits.device
    data = state.sets_bits[torch.as_tensor(set_id, device=dev).long(),
                           torch.as_tensor(row, device=dev).long()]
    return state, data, c0 + _count(dev, reads=1)


# ===========================================================================
# Cache-mode controller (functional hit/miss engine).  One CAM set (512
# tag columns) serves one RAM superset (512 data blocks), Fig. 7.
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class CacheState:
    tags: torch.Tensor      # ([G,] n_sets, ways) int32 — stored tags
    valid: torch.Tensor     # ([G,] n_sets, ways) int8
    dirty: torch.Tensor     # ([G,] n_sets, ways) int8
    counter: torch.Tensor   # ([G]) int32 — free-running replacement counter


def init_cache(n_sets: int, ways: int = 512,
               device: str | torch.device = "cuda",
               lanes: int | None = None) -> CacheState:
    dev = resolve_device(device)
    g = () if lanes is None else (lanes,)
    z = lambda dt: torch.zeros(g + (n_sets, ways), dtype=dt, device=dev)
    return CacheState(tags=z(_I32), valid=z(torch.int8), dirty=z(torch.int8),
                      counter=torch.zeros(g, dtype=_I32, device=dev))


def cache_lookup(state: CacheState, set_id, tag):
    """One CAM search: ``(hit, way)``."""
    ix = lanes.index(state.tags, 2, set_id)
    tag = torch.as_tensor(tag, device=state.tags.device)
    line = (state.tags[ix] == tag[..., None]) & (state.valid[ix] == 1)
    return line.any(-1), lanes.first(line).to(_I32)


def cache_install(state: CacheState, set_id, tag, make_dirty):
    """Install per §7: prefer an invalid way, else a clean way, both
    searched from the rotating counter, else evict the (dirty) way at the
    counter.  Returns ``(state, evicted_dirty, way)``."""
    dev = state.tags.device
    ways = state.tags.shape[-1]
    ix = lanes.index(state.tags, 2, set_id)
    valid_row = state.valid[ix]
    dirty_row = state.dirty[ix]

    # Every way choice walks from the shared free-running counter (§8),
    # which spaces two installs at one location by >= `ways` evictions.
    start = (state.counter % ways).long()
    order = (torch.arange(ways, device=dev) + start[..., None]) % ways
    invalid = valid_row.gather(-1, order) == 0
    clean = dirty_row.gather(-1, order) == 0
    at = lambda i: order.gather(-1, i[..., None]).squeeze(-1)
    has_invalid, has_clean = invalid.any(-1), clean.any(-1)
    ctr_way = order[..., 0]
    way = torch.where(has_invalid, at(lanes.first(invalid)),
                      torch.where(has_clean, at(lanes.first(clean)), ctr_way))
    ctr_dirty = dirty_row.gather(-1, ctr_way[..., None]).squeeze(-1) == 1
    evicted_dirty = ~has_invalid & ~has_clean & ctr_dirty

    wix = ix + (way,)
    dirty = torch.as_tensor(make_dirty, device=dev).to(torch.int8)
    new = CacheState(
        tags=lanes.put(state.tags, wix, tag),
        valid=lanes.put(state.valid, wix, 1),
        dirty=lanes.put(state.dirty, wix, dirty),
        counter=state.counter + 1,
    )
    return new, evicted_dirty, way.to(_I32)


def dirty_set_mask(state: CacheState) -> torch.Tensor:
    """([G,] n_sets) bool — sets holding at least one dirty line; the
    simulator's rotation flush invalidates exactly these."""
    return state.dirty.to(_I32).sum(-1) > 0


def cache_invalidate_sets(state: CacheState, set_mask: torch.Tensor):
    """Flush whole sets (rotation): ``(state, n_dirty_written_back)``."""
    dirty_per_set = (state.dirty * state.valid).to(_I32).sum(-1)
    flushed = torch.where(set_mask, dirty_per_set, 0).sum(-1)
    keep = (~set_mask)[..., None]
    return CacheState(
        tags=state.tags,
        valid=torch.where(keep, state.valid, 0).to(torch.int8),
        dirty=torch.where(keep, state.dirty, 0).to(torch.int8),
        counter=state.counter,
    ), flushed.to(_I32)
