"""Lifetime estimation from wear snapshots (paper §10.3, Fig. 11).

The paper's methodology: record per-row/column write counts at every
rotation, then model a constantly repeated execution of the application with
the rotary offset applied at each rotation; lifetime ends when any cell
exceeds its endurance.  We reproduce that as a CUMULATIVE-CROSSING replay:
accumulate the epoch's per-superset write counts under the rotating prime-
offset schedule until the hottest physical location crosses ``endurance``,
then convert crossing time to years.

Granularity note (recorded in EXPERIMENTS.md): our snapshots are per-
SUPERSET (the wear-leveling mechanism's own granularity); the paper's
snapshots additionally resolve within-superset rows/columns, whose residual
skew is why their Monarch lands at 61% of ideal.  At superset granularity a
covering prime schedule approaches ideal; the within-superset term is
bounded separately by ``intra_set_skew``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import geometry
from repro_torch.core.timing import CPU_HZ, SECONDS_PER_YEAR, DEFAULT_ENDURANCE


@dataclasses.dataclass
class LifetimeResult:
    years: float
    ideal_years: float
    max_cell_writes_per_epoch: float
    epochs_to_death: float


def estimate_from_ops(
    writes_per_set: np.ndarray,
    ops_total: int,
    rotations: int,
    endurance: float = DEFAULT_ENDURANCE,
    ops_per_second: float = 1e6,
) -> "LifetimeResult":
    """Serving-side bridge: op-counter clock -> the Fig. 11 replay.

    The serving layers (MonarchKVIndex, HopscotchTable) count ops instead
    of cycles; this is the ONE conversion (ops / ops_per_second seconds,
    then CPU cycles) both use, so the cycle-proxy semantics cannot drift
    between them."""
    epoch_s = max(int(ops_total), 1) / ops_per_second
    return estimate_lifetime(
        np.asarray(writes_per_set, np.float64),
        epoch_cycles=epoch_s * CPU_HZ,
        rotations_per_epoch=int(rotations),
        endurance=endurance)


def _offsets_sequence(n_rotations: int) -> np.ndarray:
    """Cumulative combined offset (superset-granularity permutation shift)
    after each rotation, following the prime schedule of §8."""
    off = geometry.zero_offsets("cpu")
    shifts = np.zeros((n_rotations,), np.int64)
    for r in range(n_rotations):
        off = geometry.apply_rotate(off)
        shifts[r] = int(off.superset) + int(off.set_) + int(off.bank) + int(off.vault)
    return shifts


def estimate_lifetime(
    writes_per_superset: np.ndarray,
    epoch_cycles: float,
    rotations_per_epoch: int = 1,
    endurance: float = DEFAULT_ENDURANCE,
    writes_per_block_write: float = 1.0,
    intra_set_skew: float = 1.0,
) -> LifetimeResult:
    """Replay repeated execution with rotary remapping until the hottest
    physical superset crosses ``endurance``.

    writes_per_superset : logical write counts for one application epoch.
    epoch_cycles        : duration of that epoch in CPU cycles.
    rotations_per_epoch : rotate signals fired during the epoch (0 = the
                          offsets never move; wear stays concentrated).
    intra_set_skew      : hottest-cell/mean factor INSIDE a superset
                          (1.0 = even; replacement-counter placement keeps
                          it near 1; pass >1 to bound tag-row hotspots).

    A cell in a block sees ~1 programming pulse per block write (row write
    pulses its full row once); ``writes_per_block_write`` scales this.
    """
    w_even = np.asarray(writes_per_superset, np.float64) * writes_per_block_write
    # intra-set skew raises the hottest CELL's rate, not the ideal (which
    # assumes perfectly even distribution inside supersets too).
    w = w_even * intra_set_skew
    n = len(w)
    epoch_seconds = epoch_cycles / CPU_HZ
    total = float(w.sum())
    mean_per_epoch = float(w_even.sum()) / n

    def years_from_epochs(epochs: float) -> float:
        return epochs * epoch_seconds / SECONDS_PER_YEAR

    ideal_years = (years_from_epochs(endurance / mean_per_epoch)
                   if mean_per_epoch > 0 else float("inf"))

    if total <= 0:
        return LifetimeResult(float("inf"), ideal_years, 0.0, float("inf"))

    if rotations_per_epoch <= 0:
        # No rotation: wear concentrates on the static mapping forever.
        mx = float(w.max())
        return LifetimeResult(
            years=years_from_epochs(endurance / mx),
            ideal_years=ideal_years,
            max_cell_writes_per_epoch=mx,
            epochs_to_death=endurance / mx,
        )

    # Cumulative-crossing replay: one chunk = one rotation period.
    n_steps = rotations_per_epoch
    per_rotation = w / n_steps
    shifts = _offsets_sequence(max(16 * n, 4 * n_steps))
    phys = np.zeros(n, np.float64)
    idx = np.arange(n)
    steps_done = 0
    # Pre-rotation first period uses the identity mapping.
    schedule = np.concatenate([[0], shifts])
    while phys.max() < endurance and steps_done < len(schedule):
        s = schedule[steps_done % len(schedule)]
        phys[(idx + s) % n] += per_rotation
        steps_done += 1
    if phys.max() >= endurance:
        # Interpolate within the final step.
        over = phys.max() - endurance
        last = per_rotation.max() if per_rotation.max() > 0 else 1.0
        frac = min(over / last, 1.0)
        steps = steps_done - frac
    else:
        # Schedule exhausted without death: extrapolate from the (near-
        # steady-state) accumulated maximum.
        steps = steps_done * endurance / phys.max()
    epochs = steps / n_steps
    mx_epoch = float(w.max())
    return LifetimeResult(
        years=years_from_epochs(epochs),
        ideal_years=ideal_years,
        max_cell_writes_per_epoch=mx_epoch,
        epochs_to_death=epochs,
    )
