"""Trace-driven memory-hierarchy simulator (paper §9-§10 methodology) —
port of ``repro/core/simulator.py`` over torch tensors.

Models the path  L3 -> in-package cache (Monarch or baseline) -> DDR4  for
a stream of memory requests, one step per request, for the paper's
*relative* performance study (Fig. 9/10) and the lifetime study (Fig. 11).
Timing comes verbatim from Table 3, the cache organizations from §7 and
the durability machinery (t_MWW superset locking, D/R install filter,
rotary wear leveling) from §8.  Every quantity is int32, as in the
reference (which runs without x64), so the two agree bit for bit.

Performance model: open-loop with bounded memory-level parallelism —
request *i* may not issue until request *i - MLP* has completed.  Each
access seizes a bank chosen by address; banks serialize (``bank_free``),
and DRAM-style banks keep an open-row register (row hit tCAS+tBL,
conflict tRP+tRCD+tCAS+tBL).  Monarch looks tags up with one SEARCH in
the vault's CAM bank and reads data from a RAM bank; D-Cache-style
caches read the tag with the data in one bank.

Batched engine: configs are grouped into shape families (``SimShape``,
the array sizes); everything else (``DynParams``: Table 3 scalars, policy
flags, §8 knobs) is per-lane data.  A family's whole config x trace grid
runs as one lane-batched step with a leading lane axis ``G`` on every
state field (config-major: lane ``i * n_traces + j``).  The step makes
no host synchronisation, so on a CUDA card ``GRAPH_STEPS`` steps are
captured once per family as a CUDA graph and replayed over the trace;
on the CPU the same step runs eagerly in a Python loop.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import controller, lanes, wear
from repro_torch.core.timing import TABLE1, TECH_TIMING, InterfaceTiming
from repro_torch.device import resolve_device
from repro_torch.pytree import tree_leaves, tree_map

MLP = 16            # outstanding-miss budget (8 cores x 2 threads, §9.1)
L3_LATENCY = 42     # cycles; identical across systems
CPU_GAP = 4         # non-memory work between misses reaching the L3

#: Steps captured in one CUDA graph; a trace's last ``T mod GRAPH_STEPS``
#: steps run eagerly through the same step.
GRAPH_STEPS = 64

_I32 = torch.int32
_INT32_MAX = 2 ** 31 - 1
_INT32_MIN = -2 ** 31


@dataclasses.dataclass(frozen=True)
class SimConfig:
    name: str
    tech: str                    # key into TECH_TIMING
    inpkg_sets: int
    inpkg_ways: int
    search_tags: bool            # True: CAM search; False: tag read
    l3_sets: int = 64
    l3_ways: int = 16
    # Monarch durability knobs.
    wear_enabled: bool = False
    m_writes: int = 3
    dr_filter: bool = False      # D/R-flag selective install (§8)
    no_allocate: bool = True     # miss fills go to L3 only (§8)
    t_mww_cycles: int = 1 << 22  # scaled window for simulation
    dc_limit: int = 256          # scaled dirty-counter limit
    window_budget_blocks: int = 0  # t_MWW budget blocks (0 = inpkg_ways)
    energy_tech: str = "2R XAM"  # Table 1 row for per-op energy

    @property
    def inpkg_blocks(self) -> int:
        return self.inpkg_sets * self.inpkg_ways

    @property
    def timing(self) -> InterfaceTiming:
        return TECH_TIMING[self.tech]


def baseline_configs(scale_blocks: int = 4096) -> dict[str, SimConfig]:
    """The paper's §10.2 systems.  ``scale_blocks`` = number of 64B blocks
    the (scaled) 4GB DRAM stack holds; every other capacity keeps the
    paper's ratio to it (Monarch/RRAM 2x, CMOS 73/4096x).  Baselines are
    allocate-on-miss caches; only Monarch uses the §8 no-allocate + D/R
    selective-install policy."""
    dram_blocks = scale_blocks
    monarch_blocks = scale_blocks * 2
    cmos_blocks = max(64, int(scale_blocks * 73 / 4096))
    mk = SimConfig
    cfgs = {
        "d_cache": mk(name="d_cache", tech="dram",
                      inpkg_sets=dram_blocks // 16, inpkg_ways=16,
                      search_tags=False, no_allocate=False,
                      energy_tech="DRAM"),
        "d_cache_ideal": mk(name="d_cache_ideal", tech="dram_ideal",
                            inpkg_sets=dram_blocks // 16, inpkg_ways=16,
                            search_tags=False, no_allocate=False,
                            energy_tech="DRAM"),
        "s_cache": mk(name="s_cache", tech="cmos",
                      inpkg_sets=max(cmos_blocks // 16, 1), inpkg_ways=16,
                      search_tags=True, no_allocate=False,
                      energy_tech="SRAM+SCAM"),
        "rc_unbound": mk(name="rc_unbound", tech="rram_1r",
                         inpkg_sets=monarch_blocks // 16, inpkg_ways=16,
                         search_tags=False, no_allocate=False,
                         energy_tech="1R RAM"),
        "monarch_unbound": mk(name="monarch_unbound", tech="monarch",
                              inpkg_sets=monarch_blocks // 512, inpkg_ways=512,
                              search_tags=True, dr_filter=True,
                              energy_tech="2R XAM"),
    }
    for m in (1, 2, 3, 4):
        cfgs[f"monarch_m{m}"] = mk(
            name=f"monarch_m{m}", tech="monarch",
            inpkg_sets=monarch_blocks // 512, inpkg_ways=512,
            search_tags=True, wear_enabled=True, m_writes=m, dr_filter=True,
            energy_tech="2R XAM")
    return cfgs


# ---------------------------------------------------------------------------
# Static shape family vs dynamic per-lane parameters.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimShape:
    """Array-shape statics: configs sharing a SimShape run as lanes of one
    batched step."""
    l3_sets: int
    l3_ways: int
    inpkg_sets: int
    inpkg_ways: int
    n_banks: int        # in-package banks (vaults x banks/vault)


def shape_of(cfg: SimConfig) -> SimShape:
    t = cfg.timing
    return SimShape(
        l3_sets=cfg.l3_sets, l3_ways=cfg.l3_ways,
        inpkg_sets=cfg.inpkg_sets, inpkg_ways=cfg.inpkg_ways,
        n_banks=t.n_vaults * t.banks_per_vault,
    )


@dataclasses.dataclass(frozen=True)
class DynTiming:
    """The Table 3 scalars the step reads, as int32 tensors (bool for
    ``needs_precharge``).  The DDR4 side stays the static
    ``TECH_TIMING["ddr4"]``; ``_access`` takes either."""
    tRCD: torch.Tensor
    tCAS: torch.Tensor
    tCCD: torch.Tensor
    tWR: torch.Tensor
    tBL: torch.Tensor
    tCWD: torch.Tensor
    tRP: torch.Tensor
    tRC: torch.Tensor
    needs_precharge: torch.Tensor


@dataclasses.dataclass(frozen=True)
class DynParams:
    """Per-lane dynamic parameters."""
    timing: DynTiming
    search_tags: torch.Tensor       # bool
    allocate_on_miss: torch.Tensor  # bool (= not cfg.no_allocate)
    dr_filter: torch.Tensor         # bool
    wear_enabled: torch.Tensor      # bool
    wear: wear.WearDyn


def _dyn_numpy(cfg: SimConfig) -> DynParams:
    t = cfg.timing
    i32 = lambda v: np.int32(v)
    wcfg = wear.WearConfig(
        n_supersets=cfg.inpkg_sets, m_writes=cfg.m_writes,
        dc_limit=cfg.dc_limit, t_mww_cycles=cfg.t_mww_cycles,
        blocks_per_superset=cfg.window_budget_blocks or cfg.inpkg_ways)
    return DynParams(
        timing=DynTiming(
            tRCD=i32(t.tRCD), tCAS=i32(t.tCAS), tCCD=i32(t.tCCD),
            tWR=i32(t.tWR), tBL=i32(t.tBL), tCWD=i32(t.tCWD),
            tRP=i32(t.tRP), tRC=i32(t.tRC),
            needs_precharge=np.bool_(t.needs_precharge)),
        search_tags=np.bool_(cfg.search_tags),
        allocate_on_miss=np.bool_(not cfg.no_allocate),
        dr_filter=np.bool_(cfg.dr_filter),
        wear_enabled=np.bool_(cfg.wear_enabled),
        wear=wear.WearDyn(
            window_write_budget=i32(wcfg.window_write_budget),
            dc_limit=i32(wcfg.dc_limit), wc_limit=i32(wcfg.wc_limit),
            wr_shift=i32(wcfg.wr_shift), t_mww_cycles=i32(wcfg.t_mww_cycles)),
    )


def dyn_params(cfgs, device: str | torch.device = "cuda") -> DynParams:
    """The dynamic parameters of a sequence of configs, one per lane, as
    ``(G,)`` tensors (the reference's ``dyn_params`` stacked over lanes)."""
    dev = resolve_device(device)
    per_lane = [_dyn_numpy(c) for c in cfgs]
    return tree_map(lambda *xs: torch.from_numpy(np.stack(xs)).to(dev),
                    *per_lane)


# ---------------------------------------------------------------------------
# Step state.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimState:
    # L3 (functional, LRU) + per-line Dirty/Read flags for the §8 filter.
    l3_tags: torch.Tensor     # ([G,] sets, ways) int32
    l3_valid: torch.Tensor    # ([G,] sets, ways) int8
    l3_dirty: torch.Tensor
    l3_read: torch.Tensor
    l3_age: torch.Tensor      # ([G,] sets, ways) int32
    # In-package cache.
    cache: controller.CacheState
    # Bank/row-buffer timing state.
    inpkg_bank_free: torch.Tensor   # ([G,] n_banks) int32
    inpkg_open_row: torch.Tensor    # ([G,] n_banks) int32 (-1 = closed)
    ddr_bank_free: torch.Tensor     # ([G,] ddr_banks) int32
    ddr_open_row: torch.Tensor
    # MLP ring + clock.
    completions: torch.Tensor       # ([G,] MLP) int32
    arrival: torch.Tensor           # ([G]) int32
    # Durability.
    wear: wear.WearState
    # Per-set install-write counts (lifetime estimation, Fig. 11).
    set_writes: torch.Tensor        # ([G,] n_sets) int32
    # Per-(set, way) install counts: within-superset wear skew (Fig. 11).
    set_way_writes: torch.Tensor    # ([G,] n_sets, ways) int32
    # Stats.
    stats: torch.Tensor             # ([G,] NSTATS) int32


STAT_NAMES = [
    "l3_hits", "l3_misses", "inpkg_hits", "inpkg_misses", "inpkg_reads",
    "inpkg_writes", "inpkg_searches", "ddr_reads", "ddr_writes",
    "installs_skipped", "writes_filtered", "locked_bypass", "rotates",
    "flushed_dirty", "evict_writebacks", "l3_evictions",
]
NSTATS = len(STAT_NAMES)
SIDX = {n: i for i, n in enumerate(STAT_NAMES)}


def init_state(cfg: SimConfig | SimShape, device: str | torch.device = "cuda",
               lanes: int | None = None) -> SimState:
    """Fresh state; ``lanes=G`` gives every field a leading lane axis."""
    shape = cfg if isinstance(cfg, SimShape) else shape_of(cfg)
    dev = resolve_device(device)
    g = () if lanes is None else (lanes,)
    dt = TECH_TIMING["ddr4"]
    ddr_banks = dt.n_vaults * dt.banks_per_vault
    z = lambda *s, dtype=_I32: torch.zeros(g + s, dtype=dtype, device=dev)
    l3 = (shape.l3_sets, shape.l3_ways)
    return SimState(
        l3_tags=z(*l3), l3_valid=z(*l3, dtype=torch.int8),
        l3_dirty=z(*l3, dtype=torch.int8), l3_read=z(*l3, dtype=torch.int8),
        l3_age=z(*l3),
        cache=controller.init_cache(shape.inpkg_sets, shape.inpkg_ways, dev,
                                    lanes),
        inpkg_bank_free=z(shape.n_banks),
        inpkg_open_row=torch.full(g + (shape.n_banks,), -1, dtype=_I32,
                                  device=dev),
        ddr_bank_free=z(ddr_banks),
        ddr_open_row=torch.full(g + (ddr_banks,), -1, dtype=_I32, device=dev),
        completions=z(MLP),
        arrival=z(),
        wear=wear.init_state(wear.WearConfig(n_supersets=shape.inpkg_sets),
                             dev, lanes),
        set_writes=z(shape.inpkg_sets),
        set_way_writes=z(shape.inpkg_sets, shape.inpkg_ways),
        stats=z(NSTATS),
    )


# --------------------------- bank access helpers ---------------------------

def _sel(cond, a, b):
    """``where(cond, a, b)``; a Python-bool ``cond`` (a static timing's
    flag) selects without computing, as XLA folds the reference's."""
    if isinstance(cond, bool):
        return a if cond else b
    return lanes.pick(cond, a, b)


def _access(bank_free, open_row, bank, row, when, t, is_write):
    """Seize ``bank`` at >= ``when``; returns (bank_free', open_row', done).

    ``bank`` indexes ``bank_free``/``open_row`` (``(lane, bank)`` over a
    lane-batched state); ``t`` is a static ``InterfaceTiming`` (DDR4) or a
    per-lane ``DynTiming``.  Both row-buffer disciplines are computed and
    selected on ``needs_precharge``."""
    start = torch.maximum(when, bank_free[bank])
    row_hit = open_row[bank] == row
    lat_pre = torch.where(row_hit, t.tCAS + t.tBL,
                          t.tRP + t.tRCD + t.tCAS + t.tBL)
    occ_pre = torch.where(row_hit, t.tCCD, t.tRC)
    lat_nopre = t.tRCD + t.tCAS + t.tBL
    occ_nopre = t.tCCD
    pre = t.needs_precharge
    lat_r = _sel(pre, lat_pre, lat_nopre)
    occ_r = _sel(pre, occ_pre, occ_nopre)
    open_row = _sel(pre, lanes.put(open_row, bank, row), open_row)
    lat_w = t.tCWD + t.tWR + t.tBL
    occ_w = (max(t.tCCD, t.tWR) if isinstance(t, InterfaceTiming)
             else torch.maximum(t.tCCD, t.tWR))
    done = (start + _sel(is_write, lat_w, lat_r)).to(_I32)
    busy = (start + _sel(is_write, occ_w, occ_r)).to(_I32)
    return lanes.put(bank_free, bank, busy), open_row, done


# ------------------------------- step fn -----------------------------------

# Stats bumped by a (G,) bool flag, in the order the step raises them.
_FLAG_STATS = ["l3_hits", "l3_misses", "l3_evictions", "locked_bypass",
               "inpkg_searches", "inpkg_reads", "inpkg_hits", "inpkg_reads",
               "inpkg_misses", "ddr_reads", "writes_filtered", "inpkg_writes",
               "evict_writebacks", "ddr_writes"]
_WEAR_FLAG_STATS = ["rotates"]


def make_step(shape: SimShape, dyn: DynParams, wear_on: bool = True):
    """Build the lane-batched step ``step(state, addr, is_write) ->
    (state, completion)`` over ``G`` lanes: ``dyn`` leaves, ``addr`` and
    ``is_write`` are ``(G,)``; the state carries a leading lane axis.

    ``wear_on`` is static: when no lane of the family has wear enabled,
    the §8 wear accounting and the rotation flush are left out of the
    step instead of computed and discarded.  The step is functional (its
    input state is not written) and makes no host synchronisation."""
    t = dyn.timing
    dt = TECH_TIMING["ddr4"]
    n_banks = shape.n_banks
    ddr_banks = dt.n_vaults * dt.banks_per_vault
    n_sets = shape.inpkg_sets
    dev = dyn.search_tags.device
    n_lanes = dyn.search_tags.shape[0]
    lane = torch.arange(n_lanes, device=dev)
    flag_names = _FLAG_STATS + (_WEAR_FLAG_STATS if wear_on else [])
    flag_cols = torch.tensor([SIDX[n] for n in flag_names], device=dev)
    flushed_col = SIDX["flushed_dirty"]
    search_latency = t.tRCD + t.tCAS + t.tBL
    w_occ = torch.maximum(t.tCCD, t.tWR)
    ddr_w_occ = max(dt.tCCD, dt.tWR)

    def step(state: SimState, addr, is_write):
        addr = addr.to(_I32)
        is_write = is_write.to(torch.bool)
        flags = []

        # ---- issue gating: bounded MLP ---------------------------------
        slot = (state.stats[:, SIDX["l3_misses"]] % MLP).long()  # miss count
        arrival = torch.maximum(state.arrival + CPU_GAP,
                                state.completions[lane, slot])

        # ---- L3 ---------------------------------------------------------
        l3_set = addr % shape.l3_sets
        l3_tag = addr // shape.l3_sets
        row = (lane, l3_set.long())
        tags_row, valid_row = state.l3_tags[row], state.l3_valid[row]
        line = (tags_row == l3_tag[:, None]) & (valid_row == 1)
        l3_hit = line.any(-1)
        l3_way = lanes.first(line)

        # LRU bookkeeping: invalid ways score INT32_MAX, so they go first.
        age_row = state.l3_age[row] + 1
        victim = torch.argmax(
            torch.where(valid_row == 1, age_row, _INT32_MAX), dim=-1)
        way = torch.where(l3_hit, l3_way, victim)
        at_way = lambda r: r.gather(1, way[:, None]).squeeze(1)
        old_dirty = at_way(state.l3_dirty[row])
        old_read = at_way(state.l3_read[row])
        ev_valid = ~l3_hit & (at_way(valid_row) == 1)
        ev_tag = at_way(tags_row)
        ev_dirty = old_dirty == 1
        ev_read = old_read == 1
        ev_addr = ev_tag * shape.l3_sets + l3_set

        cell = row + (way,)
        w8 = is_write.to(torch.int8)
        l3_tags = lanes.put(state.l3_tags, cell, l3_tag)
        l3_valid = lanes.put(state.l3_valid, cell, 1)
        l3_dirty = lanes.put(state.l3_dirty, cell,
                             torch.where(l3_hit, old_dirty | w8, w8))
        # R flag = read AFTER installation (§8): a fill starts with R=0.
        l3_read = lanes.put(state.l3_read, cell,
                            torch.where(l3_hit, old_read | (1 - w8), 0))
        age = lanes.put(state.l3_age, row, age_row.scatter(1, way[:, None], 0))
        flags += [l3_hit, ~l3_hit, ev_valid]

        # ---- MISS PATH: in-package lookup, predicated on ~l3_hit -------
        miss = ~l3_hit
        offs = state.wear.offsets
        off = offs.superset + offs.set_ + offs.bank + offs.vault
        set_id = (addr % n_sets + off) % n_sets   # rotary remap (§8)
        tag = addr // n_sets
        hit, _ = controller.cache_lookup(state.cache, set_id, tag)
        hit = hit & miss
        locked = wear.is_locked(state.wear, set_id, arrival) & dyn.wear_enabled
        hit = hit & ~locked  # locked superset: bypass to main memory
        flags.append(miss & locked)

        # CAM lookup bank and RAM data bank (decoupled tags/data, §7).
        cam_bank = (lane, (set_id % max(n_banks // 8, 1)).long())
        ram_bank = (lane, ((tag + set_id) % n_banks).long())
        inpkg_row = (addr // (n_sets * 8)) % 1024

        bank_free, open_row = state.inpkg_bank_free, state.inpkg_open_row
        # (a) SEARCH in the CAM bank; (b) tag READ in the data bank.
        s_start = torch.maximum(arrival, bank_free[cam_bank])
        s_done = s_start + search_latency
        bf_search = lanes.put(bank_free, cam_bank, torch.where(
            miss, s_start + t.tCCD, bank_free[cam_bank]))
        bf_tr, or_tr, tag_done_r = _access(bank_free, open_row, ram_bank,
                                           inpkg_row, arrival, t, False)
        bf_tag = lanes.pick(miss, bf_tr, bank_free)
        or_tag = lanes.pick(miss, or_tr, open_row)
        bank_free = lanes.pick(dyn.search_tags, bf_search, bf_tag)
        open_row = lanes.pick(dyn.search_tags, open_row, or_tag)
        tag_done = torch.where(
            miss, torch.where(dyn.search_tags, s_done, tag_done_r), arrival)
        flags += [miss & dyn.search_tags, miss & ~dyn.search_tags]

        # Data read on hit.
        bf3, or3, data_done = _access(bank_free, open_row, ram_bank,
                                      inpkg_row, tag_done, t, False)
        bank_free = lanes.pick(hit, bf3, bank_free)
        open_row = lanes.pick(hit, or3, open_row)
        inpkg_miss = miss & ~hit
        flags += [hit, hit, inpkg_miss]

        # DDR access on in-package miss.
        ddr_bank = (lane, (addr % ddr_banks).long())
        ddr_row = (addr // ddr_banks) % 65536
        dbf, dor, ddr_done = _access(state.ddr_bank_free, state.ddr_open_row,
                                     ddr_bank, ddr_row, tag_done, dt, False)
        ddr_bank_free = lanes.pick(inpkg_miss, dbf, state.ddr_bank_free)
        ddr_open_row = lanes.pick(inpkg_miss, dor, state.ddr_open_row)
        flags.append(inpkg_miss)

        completion = torch.where(
            l3_hit, arrival + L3_LATENCY,
            torch.where(hit, data_done, ddr_done) + L3_LATENCY)

        # ---- fill policy and L3 eviction handling (§8) ------------------
        cache = state.cache
        wstate = state.wear
        do_install_miss = inpkg_miss & dyn.allocate_on_miss
        inst_dr, fwd_dr = wear.install_decision(ev_dirty, ev_read)
        # Plain writeback cache (no D/R filter): dirty evictions update the
        # in-package copy; clean evictions are dropped.
        inst = torch.where(dyn.dr_filter, inst_dr, ev_dirty)
        fwd = dyn.dr_filter & fwd_dr
        ev_install = ev_valid & inst & ~locked
        ev_forward = ev_valid & (fwd | locked) & ev_dirty
        flags.append(ev_valid & ~inst)

        ev_set = (ev_addr % n_sets + off) % n_sets
        install_any = ev_install | do_install_miss
        inst_set = torch.where(ev_install, ev_set, set_id)
        inst_tag = torch.where(ev_install, ev_addr // n_sets, tag)
        inst_dirty = torch.where(ev_install, ev_dirty, is_write)
        cache2, evicted_dirty, inst_way = controller.cache_install(
            cache, inst_set, inst_tag, inst_dirty)
        cache = lanes.pick(install_any, cache2, cache)
        flags += [install_any, install_any & evicted_dirty]

        # Charge the write on the RAM bank (occupancy tWR — the RRAM pain).
        w_bank = (lane, ((inst_tag + inst_set) % n_banks).long())
        w_start = torch.maximum(arrival, bank_free[w_bank])
        bank_free = lanes.put(bank_free, w_bank, torch.where(
            install_any, w_start + w_occ, bank_free[w_bank]))

        # Forwarded dirty evictions + in-package dirty evictions to DDR4.
        ddr_w = ev_forward | (install_any & evicted_dirty)
        dwb = (lane, (ev_addr % ddr_banks).long())
        dw_start = torch.maximum(arrival, ddr_bank_free[dwb])
        ddr_bank_free = lanes.put(ddr_bank_free, dwb, torch.where(
            ddr_w, dw_start + ddr_w_occ, ddr_bank_free[dwb]))
        flags.append(ddr_w)

        stats = state.stats.clone()
        # ---- wear accounting + rotation (elided for a wear-free family) --
        if wear_on:
            wstate2, rotated, _ = wear.record_write(
                wstate, dyn.wear, inst_set, inst_dirty, arrival)
            wear_apply = install_any & dyn.wear_enabled
            wstate = lanes.pick(wear_apply, wstate2, wstate)
            rot_now = wear_apply & rotated
            # The dirty sets are read from the pre-install cache; the flush
            # acts on the post-install one.
            set_mask = controller.dirty_set_mask(state.cache)
            cache3, n_flush = controller.cache_invalidate_sets(cache, set_mask)
            cache = lanes.pick(rot_now, cache3, cache)
            flags.append(rot_now)
            stats[:, flushed_col] += torch.where(rot_now, n_flush, 0)
        stats.index_add_(1, flag_cols, torch.stack(flags, 1).to(_I32))

        at_set = (lane, inst_set.long())
        inc = install_any.to(_I32)
        set_writes = lanes.put(state.set_writes, at_set,
                               state.set_writes[at_set] + inc)
        at_way_ = at_set + (inst_way.long(),)
        set_way_writes = lanes.put(state.set_way_writes, at_way_,
                                   state.set_way_writes[at_way_] + inc)

        # ---- retire -------------------------------------------------------
        at_slot = (lane, slot)
        completions = lanes.put(state.completions, at_slot, torch.where(
            miss, completion, state.completions[at_slot]))

        new = SimState(
            l3_tags=l3_tags, l3_valid=l3_valid, l3_dirty=l3_dirty,
            l3_read=l3_read, l3_age=age,
            cache=cache,
            inpkg_bank_free=bank_free, inpkg_open_row=open_row,
            ddr_bank_free=ddr_bank_free, ddr_open_row=ddr_open_row,
            completions=completions,
            arrival=torch.maximum(arrival, state.arrival),
            wear=wstate, set_writes=set_writes,
            set_way_writes=set_way_writes, stats=stats,
        )
        return new, completion

    return step


# ---------------------------------------------------------------------------
# Running a family: eager on the CPU, CUDA-graph replay on the card.
# ---------------------------------------------------------------------------

def capture_steps(step, state: SimState, top: torch.Tensor,
                  addr_buf: torch.Tensor, write_buf: torch.Tensor,
                  keep_graph: bool = False) -> "torch.cuda.CUDAGraph":
    """Capture ``len(addr_buf)`` steps as one CUDA graph that reads request
    ``k`` from ``addr_buf[k]``/``write_buf[k]`` (each ``(G,)``), and writes
    the final state into ``state``'s tensors and the running maximum of
    the completions into ``top``, in place, so their addresses stay fixed
    across replays.  Refill the buffers, then ``replay()``.  Capture runs
    nothing: ``state`` holds its values until the first replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up; the step is functional
        step(state, addr_buf[0], write_buf[0])
    torch.cuda.current_stream().wait_stream(side)
    # ``keep_graph`` keeps the cudaGraph_t for inspection (node counts).
    graph = (torch.cuda.CUDAGraph(keep_graph=True) if keep_graph
             else torch.cuda.CUDAGraph())
    with torch.cuda.graph(graph):
        st, m = state, top
        for k in range(addr_buf.shape[0]):
            st, completion = step(st, addr_buf[k], write_buf[k])
            m = torch.maximum(m, completion)
        for dst, src in zip(tree_leaves(state), tree_leaves(st)):
            dst.copy_(src)
        top.copy_(m)
    return graph


def run_family(shape: SimShape, wear_on: bool, dyn: DynParams,
               addrs: torch.Tensor, is_write: torch.Tensor):
    """Run ``G`` lanes through their traces (``addrs``/``is_write``
    ``(G, T)`` on the run's device).  Returns the final lane-batched state
    and each lane's maximum completion ``(G,)``."""
    n_lanes, n_req = addrs.shape
    dev = addrs.device
    state = init_state(shape, dev, lanes=n_lanes)
    step = make_step(shape, dyn, wear_on)
    a_t = addrs.to(_I32).t().contiguous()          # (T, G): row k = step k
    w_t = is_write.to(torch.bool).t().contiguous()
    top = torch.full((n_lanes,), _INT32_MIN, dtype=_I32, device=dev)
    done = 0
    if dev.type == "cuda" and n_req >= GRAPH_STEPS:
        k = GRAPH_STEPS
        a_buf, w_buf = a_t[:k].clone(), w_t[:k].clone()
        graph = capture_steps(step, state, top, a_buf, w_buf)
        done = n_req - n_req % k
        for lo in range(0, done, k):
            a_buf.copy_(a_t[lo:lo + k])
            w_buf.copy_(w_t[lo:lo + k])
            graph.replay()
    for i in range(done, n_req):            # the CPU run, or the card's tail
        state, completion = step(state, a_t[i], w_t[i])
        top = torch.maximum(top, completion)
    return state, top


@dataclasses.dataclass
class SimResult:
    name: str
    total_cycles: float
    stats: dict[str, int]
    energy_nj: float

    @property
    def inpkg_hit_rate(self) -> float:
        h, m = self.stats["inpkg_hits"], self.stats["inpkg_misses"]
        return h / max(h + m, 1)


def _finish(cfg: SimConfig, max_completion, stats_row) -> SimResult:
    """Shared post-processing: refresh bandwidth tax + Table 1 energy."""
    total = float(max_completion)
    total *= 1.0 / (1.0 - cfg.timing.refresh_overhead)
    stats = {n: int(stats_row[i]) for i, n in enumerate(STAT_NAMES)}
    e = TABLE1[cfg.energy_tech]
    ddr_e = TABLE1["DRAM"]
    energy = (
        stats["inpkg_reads"] * e.read_nj
        + stats["inpkg_writes"] * e.write_nj
        + stats["inpkg_searches"] * e.search_nj
        + (stats["ddr_reads"] * ddr_e.read_nj
           + stats["ddr_writes"] * ddr_e.write_nj) * 4.0
    )
    # DRAM static/refresh energy tax (per §10.2's energy trends).
    if cfg.timing.needs_refresh:
        energy *= 1.30
    return SimResult(cfg.name, total, stats, energy)


def _lane(state: SimState, g: int) -> SimState:
    return tree_map(lambda x: x[g], state)


def simulate_trace(cfg: SimConfig, addrs, is_write,
                   return_state: bool = False,
                   device: str | torch.device = "cuda"):
    """One config over one trace (the grid engine with one lane)."""
    dev = resolve_device(device)
    a = torch.as_tensor(np.asarray(addrs)).to(_I32).to(dev)[None]
    w = torch.as_tensor(np.asarray(is_write, bool)).to(dev)[None]
    final, top = run_family(shape_of(cfg), cfg.wear_enabled,
                            dyn_params([cfg], dev), a, w)
    result = _finish(cfg, int(top[0]), final.stats[0].cpu().numpy())
    if return_state:
        return result, _lane(final, 0)
    return result


def simulate_grid(cfgs, trace_list, *, return_state: bool = False,
                  shard: bool = True, device: str | torch.device = "cuda"):
    """Run every (config, trace) pair, one lane-batched run per family.

    ``cfgs``: dict name -> SimConfig, or an iterable of SimConfigs (their
    ``.name`` is used).  ``trace_list``: iterable of (name, addrs,
    is_write); all traces must share one length.  ``shard`` spreads the
    grid axis over devices in the reference; on one device it is a no-op,
    as there.

    Returns dict[(cfg_name, trace_name)] -> SimResult, plus a dict of
    final SimStates (same keys, lane axis dropped) when ``return_state``.
    """
    del shard   # one device: the reference's _shard_grid is a no-op too
    dev = resolve_device(device)
    named = list(cfgs.items()) if isinstance(cfgs, dict) \
        else [(c.name, c) for c in cfgs]
    tr = [(n, np.asarray(a).astype(np.int32), np.asarray(w, bool))
          for n, a, w in trace_list]
    if not named or not tr:
        return ({}, {}) if return_state else {}
    n_req = tr[0][1].shape[0]
    for n, a, _ in tr:
        if a.shape[0] != n_req:
            raise ValueError(f"trace {n!r} length {a.shape[0]} != {n_req}; "
                             "grid traces must share one length")
    addrs_all = torch.from_numpy(np.stack([a for _, a, _ in tr])).to(dev)
    wr_all = torch.from_numpy(np.stack([w for _, _, w in tr])).to(dev)
    n_traces = len(tr)

    families: dict[SimShape, list[tuple[str, SimConfig]]] = {}
    for cname, cfg in named:
        families.setdefault(shape_of(cfg), []).append((cname, cfg))

    results: dict[tuple[str, str], SimResult] = {}
    states: dict[tuple[str, str], SimState] = {}
    for shape, fam in families.items():
        # Config-major lanes: lane i*n_traces + j = (cfg i, trace j).
        dyn = dyn_params([cfg for _, cfg in fam for _ in tr], dev)
        wear_on = any(cfg.wear_enabled for _, cfg in fam)
        final, top = run_family(
            shape, wear_on, dyn, addrs_all.repeat(len(fam), 1),
            wr_all.repeat(len(fam), 1))
        max_comp = top.cpu().numpy()
        stats_np = final.stats.cpu().numpy()
        for i, (cname, cfg) in enumerate(fam):
            for j, (tname, _, _) in enumerate(tr):
                g = i * n_traces + j
                results[(cname, tname)] = _finish(cfg, max_comp[g],
                                                  stats_np[g])
                if return_state:
                    states[(cname, tname)] = _lane(final, g)
    if return_state:
        return results, states
    return results


def n_shape_families(cfgs) -> int:
    """How many lane-batched runs a ``simulate_grid`` over ``cfgs`` needs."""
    named = cfgs.values() if isinstance(cfgs, dict) else cfgs
    return len({shape_of(c) for c in named})
