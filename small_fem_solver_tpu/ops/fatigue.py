"""Deterministic fatigue screening (S-N damage over phase-resolved stress).

The reference excludes fatigue entirely (its Info-tab exclusion list); this
is a SCREENING tool on top of the phase-resolved solutions the pipeline
produces anyway: a full-FEM phase scan gives every member's von Mises
history over one wave cycle, so the per-cycle stress range is exact (not a
single-point quasi-static estimate), and Miner damage for an exposure
follows from the wave count.

Scope (documented, deliberate): single sea state, one stress cycle per wave
period, von Mises range as the fatigue stress (no principal-stress hot-spot
decomposition), single-slope S-N curves.  For code-grade fatigue (spectral
scatter diagrams, SCFs per joint class, thickness corrections, bilinear
curves) feed the same stress histories into your fatigue tool of choice.

S-N curves: N = 10^loga * S^-m (S in MPa), single-slope simplifications of
the DNV-GL RP-C203 curves (the standard offshore reference):
  'D'  in air:             m = 3.0, log a = 12.164
  'D-sea-cp' seawater+CP:  m = 3.0, log a = 11.764
  'F'  in air:             m = 3.0, log a = 11.855
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

SN_CURVES = {
    "D": (3.0, 12.164),
    "D-sea-cp": (3.0, 11.764),
    "F": (3.0, 11.855),
}

SECONDS_PER_YEAR = 365.25 * 24 * 3600.0


class FatigueScreen(NamedTuple):
    stress_range_mpa: jnp.ndarray   # [M] per-cycle von Mises range * scf
    cycles_to_failure: jnp.ndarray  # [M] N(S) from the S-N curve
    damage: jnp.ndarray             # [M] Miner damage over the exposure
    life_years: jnp.ndarray         # [M] exposure_years / damage
    n_cycles: float                 # wave cycles in the exposure


def fatigue_screen(von_mises_phases, T_wave: float, exposure_years: float,
                   curve: str = "D", scf: float = 1.0,
                   occurrence: float = 1.0) -> FatigueScreen:
    """Miner damage per member from a phase-resolved von Mises history.

    ``von_mises_phases``: [S, M] stresses over one wave period (MPa) — e.g.
    ``phase_scan_condensed(...).von_mises`` or a stacked
    ``analyze_phase_batch`` result; one stress cycle per wave period with
    range = max - min over the phases.

    ``occurrence``: fraction of the exposure this sea state acts (1.0 =
    the screening assumption that the design wave runs continuously —
    conservative by construction).  ``scf`` multiplies the range (joint
    stress concentration) — a scalar or a per-member ``[M]`` vector (the
    hot-spot workflow: supply project SCFs per member, e.g. from the
    governing joint's parametric equations).
    """
    if curve not in SN_CURVES:
        raise ValueError(f"unknown S-N curve {curve!r}; "
                         f"available: {sorted(SN_CURVES)}")
    m, loga = SN_CURVES[curve]
    vm = jnp.asarray(von_mises_phases)
    S = (jnp.max(vm, axis=0) - jnp.min(vm, axis=0)) * scf     # [M]
    n_cycles = exposure_years * SECONDS_PER_YEAR / float(T_wave) * occurrence
    S_safe = jnp.maximum(S, 1e-12)
    N_fail = 10.0 ** loga * S_safe ** (-m)
    damage = jnp.where(S > 0, n_cycles / N_fail, 0.0)
    life = jnp.where(damage > 0, exposure_years / damage, jnp.inf)
    return FatigueScreen(stress_range_mpa=S, cycles_to_failure=N_fail,
                         damage=damage, life_years=life,
                         n_cycles=float(n_cycles))
