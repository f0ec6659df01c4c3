"""Timing, energy, and lifetime parameters (paper Tables 1-3, §6.2, §8).

All interface timings are in CPU cycles at 3.2 GHz, exactly as listed in
Table 3.  Table 1 gives per-operation latency/energy/area for a 32 KB
building block in each candidate technology; we carry the full table so the
technology-selection study (benchmark `table1_tech`) reproduces §5.
"""
from __future__ import annotations

import dataclasses

CPU_HZ = 3.2e9
SECONDS_PER_CYCLE = 1.0 / CPU_HZ


# ---------------------------------------------------------------------------
# Table 1 — 32KB building block per technology.
# latency ns, energy nJ, area mm^2.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Table1Row:
    read_ns: float
    write_ns: float
    search_ns: float
    read_nj: float
    write_nj: float
    search_nj: float
    area_mm2: float


TABLE1 = {
    "SRAM":      Table1Row(0.2334, 0.1892, 14.9395, 0.015, 0.0196, 0.9627, 0.0331),
    "SCAM":      Table1Row(32.2385, 0.2167, 0.5037, 0.2329, 0.0139, 0.1273, 0.111),
    "SRAM+SCAM": Table1Row(0.2334, 0.2167, 0.5037, 0.015, 0.0335, 0.1273, 0.144),
    "DRAM":      Table1Row(2.5945, 2.1874, 166.0499, 0.0657, 0.058, 4.4544, 0.0169),
    "1R RAM":    Table1Row(1.654, 20.258, 105.856, 0.0214, 0.325, 1.623, 0.0104),
    "2T2R CAM":  Table1Row(122.048, 20.825, 3.36, 2.7156, 1.29, 0.0472, 0.0153),
    "1R+2T2R":   Table1Row(1.654, 20.825, 3.36, 0.0214, 1.61, 0.0472, 0.0258),
    "2R XAM":    Table1Row(1.7734, 20.323, 3.2264, 0.0215, 0.652, 0.0263, 0.0124),
}


# ---------------------------------------------------------------------------
# Table 3 — interface timing per memory system (CPU cycles @ 3.2 GHz).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InterfaceTiming:
    tRCD: int
    tCAS: int
    tCCD: int
    tWTR: int
    tWR: int
    tRTP: int
    tBL: int
    tCWD: int
    tRP: int
    tRRD: int
    tRAS: int
    tRC: int
    tFAW: int
    # Structural properties of the stack.
    n_vaults: int = 8
    banks_per_vault: int = 8
    needs_precharge: bool = True      # DRAM row-buffer discipline
    needs_refresh: bool = True
    refresh_overhead: float = 0.05    # fraction of time unavailable
    capacity_mb: int = 4096

    # Derived service latencies for the queuing model -------------------
    def read_latency(self, row_hit: bool = False) -> int:
        base = self.tCAS + self.tBL
        if self.needs_precharge and not row_hit:
            return self.tRP + self.tRCD + base
        if not self.needs_precharge:
            return self.tRCD + base
        return base  # open-row hit

    def write_latency(self) -> int:
        return self.tCWD + self.tWR + self.tBL

    def search_latency(self) -> int:
        # Search = read with Ref_S (same datapath); technologies without
        # parallel search must stream the whole set -> modeled by caller.
        return self.tRCD + self.tCAS + self.tBL

    def bank_occupancy_read(self) -> int:
        return max(self.tCCD, self.tRC if self.needs_precharge else self.tCCD)

    def bank_occupancy_write(self) -> int:
        return max(self.tCCD, self.tWR)


# In-package DRAM (Wide I/O 2) — Table 3.
DRAM_HBM = InterfaceTiming(
    tRCD=44, tCAS=44, tCCD=16, tWTR=31, tWR=4, tRTP=46, tBL=4,
    tCWD=61, tRP=44, tRRD=16, tRAS=112, tRC=271, tFAW=181,
    n_vaults=8, banks_per_vault=8, needs_precharge=True, needs_refresh=True,
    refresh_overhead=0.05, capacity_mb=4096,
)

# Ideal DRAM cache: zero refresh / precharge / activate overheads (paper §9).
DRAM_IDEAL = dataclasses.replace(
    DRAM_HBM, needs_precharge=False, needs_refresh=False, refresh_overhead=0.0,
    tRP=0, tRCD=0, tRAS=0, tRC=16,
)

# In-package Monarch / RRAM — Table 3 (8GB, 64 banks/vault).
MONARCH = InterfaceTiming(
    tRCD=4, tCAS=4, tCCD=1, tWTR=31, tWR=162, tRTP=1, tBL=4,
    tCWD=4, tRP=8, tRRD=1, tRAS=4, tRC=12, tFAW=181,
    n_vaults=8, banks_per_vault=64, needs_precharge=False, needs_refresh=False,
    refresh_overhead=0.0, capacity_mb=8192,
)

# 1R RRAM baseline: same interface, but no parallel search capability and
# (per Table 1) slightly better read, similar write.
RRAM_1R = dataclasses.replace(MONARCH, capacity_mb=8192)

# In-package CMOS SRAM(+SCAM) — Table 3 (73.28 MB iso-area).
CMOS_SRAM = InterfaceTiming(
    tRCD=4, tCAS=4, tCCD=1, tWTR=31, tWR=3, tRTP=1, tBL=4,
    tCWD=4, tRP=8, tRRD=1, tRAS=4, tRC=12, tFAW=181,
    n_vaults=8, banks_per_vault=8, needs_precharge=False, needs_refresh=False,
    refresh_overhead=0.0, capacity_mb=73,
)

# Off-chip DDR4 main memory — Table 3.
DDR4 = InterfaceTiming(
    tRCD=44, tCAS=44, tCCD=16, tWTR=31, tWR=4, tRTP=46, tBL=10,
    tCWD=61, tRP=44, tRRD=16, tRAS=112, tRC=271, tFAW=181,
    n_vaults=2, banks_per_vault=8,  # 2 channels x 8 banks
    needs_precharge=True, needs_refresh=True, refresh_overhead=0.05,
    capacity_mb=32768,
)

TECH_TIMING = {
    "monarch": MONARCH,
    "rram_1r": RRAM_1R,
    "dram": DRAM_HBM,
    "dram_ideal": DRAM_IDEAL,
    "cmos": CMOS_SRAM,
    "ddr4": DDR4,
}


# ---------------------------------------------------------------------------
# Lifetime math (§6.2 "Constraining Block Writes", §8).
# ---------------------------------------------------------------------------

SECONDS_PER_YEAR = 365.25 * 24 * 3600

# Paper example: 3-year lifetime = 94.6e6 s, endurance 1e8 -> t_MWW = 0.94*M s
PAPER_3Y_SECONDS = 94.6e6


def t_mww_seconds(m_writes: int, t_life_seconds: float, endurance: float) -> float:
    """t_MWW = M * T_Life / n_W  — window length allowing M writes per block
    region while guaranteeing T_Life."""
    return m_writes * t_life_seconds / endurance


def t_mww_cycles(m_writes: int, t_life_seconds: float, endurance: float) -> int:
    return int(round(t_mww_seconds(m_writes, t_life_seconds, endurance) * CPU_HZ))


def lifetime_years(endurance: float, max_writes_per_second: float) -> float:
    """Years until the hottest cell reaches its endurance."""
    if max_writes_per_second <= 0:
        return float("inf")
    return endurance / max_writes_per_second / SECONDS_PER_YEAR


DEFAULT_ENDURANCE = 1e8   # §8: evaluations use 1e8 cell writes
DEFAULT_TARGET_LIFE_YEARS = 10.0  # §10.2 target lifetime
