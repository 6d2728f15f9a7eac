"""Deck air-gap (wave-in-deck clearance) check.

Beyond-reference capability: the reference never checks whether the wave
crest reaches the deck — its geometry stops at the jacket top nodes and
the Info tab (`JacketAnalysisGUI_v2.py:1544-1799`) leaves deck clearance
to the designer.  This screen evaluates the maximum crest elevation under
the platform footprint over a full wave cycle and compares it against the
deck underside with the customary margin (ISO 19902 recommends a positive
air gap of at least 1.5 m above the extreme crest; surge and tide raise
the effective still-water level).

Device shape: the crest search is one batched `surface_elevation` evaluation
over an [n_phases, n_x] grid — a single fused elementwise program, no
host loops.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from .waves import surface_elevation


class AirGapResult(NamedTuple):
    """Crest-vs-deck clearance figures (m, MWL datum)."""

    crest_m: jnp.ndarray           # max eta under the footprint over a cycle
    swl_offset_m: float            # surge + tide still-water-level rise
    deck_elevation_m: float        # deck underside above MWL
    air_gap_m: jnp.ndarray         # deck - (crest + swl)
    margin_m: float                # required clearance
    ok: jnp.ndarray                # air_gap >= margin
    crest_phase_deg: jnp.ndarray   # phase of the governing crest
    crest_x_m: jnp.ndarray         # footprint position of the governing crest


def air_gap_check(model, wave, wave_dir_deg: float = 0.0,
                  deck_elevation_m: float | None = None,
                  surge_m: float = 0.0, tide_m: float = 0.0,
                  margin_m: float = 1.5, n_phases: int = 360,
                  n_x: int = 64) -> AirGapResult:
    """Air-gap screen: max crest under the footprint vs the deck underside.

    ``deck_elevation_m`` defaults to the model's top-node elevation (the
    deck is assumed to sit on the jacket top).  The footprint is the span
    of all node positions projected onto the wave heading (compass
    ``wave_dir_deg``, same convention as the loading paths), sampled at
    ``n_x`` points; the crest is maximized over ``n_phases`` phases of one
    period.  ``surge_m`` + ``tide_m`` raise the still-water level the
    crest rides on.  ``margin_m`` is the required clearance (ISO 19902
    suggests >= 1.5 m).
    """
    if n_phases < 1 or n_x < 1:
        raise ValueError("air_gap_check needs n_phases >= 1 and n_x >= 1")
    coords = np.asarray(model.coords)
    if deck_elevation_m is None:
        top = np.where(np.asarray(model.top_mask))[0]
        if top.size == 0:
            raise ValueError("model has no top nodes; pass "
                             "deck_elevation_m explicitly")
        deck_elevation_m = float(coords[top, 2].max())
    theta = np.deg2rad(90.0 - wave_dir_deg)
    proj = coords[:, 0] * np.cos(theta) + coords[:, 1] * np.sin(theta)
    xs = jnp.linspace(float(proj.min()), float(proj.max()), n_x)
    T = 2.0 * jnp.pi / wave.omega
    ts = jnp.arange(n_phases) * T / n_phases
    eta = surface_elevation(wave, xs[None, :], ts[:, None])  # [n_phases, n_x]
    flat = jnp.argmax(eta)
    ip, ix = flat // n_x, flat % n_x
    crest = eta[ip, ix]
    swl = float(surge_m) + float(tide_m)
    gap = deck_elevation_m - (crest + swl)
    return AirGapResult(
        crest_m=crest,
        swl_offset_m=swl,
        deck_elevation_m=float(deck_elevation_m),
        air_gap_m=gap,
        margin_m=float(margin_m),
        ok=gap >= margin_m,
        crest_phase_deg=360.0 * ip / n_phases,
        crest_x_m=xs[ix],
    )
