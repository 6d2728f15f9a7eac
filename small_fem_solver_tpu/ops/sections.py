"""Thin-wall tubular section properties as a batched pytree.

Capability parity with the reference ``TubularSection`` dataclass
(`JacketAnalysisGUI_v2.py:115-160`), redesigned for an accelerator:
instead of one Python object per section, a :class:`TubeSections` pytree holds
*stacked arrays* over any number of sections so every downstream consumer
(element stiffness, Morison diameter lookup, stress recovery) is a gather +
vectorized arithmetic, never a Python loop.

All section dimensions are in mm; derived areas mm^2, inertias mm^4,
section moduli mm^3; ``mass_per_m`` is kg/m (uses ``Ax`` in m^2).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


class TubeSections(NamedTuple):
    """Stacked thin-wall tube properties; every field has shape ``[S]``.

    Field meanings match the reference attributes derived in
    ``TubularSection.__post_init__`` (`JacketAnalysisGUI_v2.py:122-137`).
    """

    D_outer: jnp.ndarray   # outer diameter [mm]
    t: jnp.ndarray         # wall thickness [mm]
    rho_steel: jnp.ndarray # steel density [kg/m^3]
    D_inner: jnp.ndarray   # [mm]
    R_outer: jnp.ndarray   # [mm]
    R_inner: jnp.ndarray   # [mm]
    Ax: jnp.ndarray        # cross-section area [mm^2]
    Ax_m2: jnp.ndarray     # cross-section area [m^2]
    Iy: jnp.ndarray        # second moment about y [mm^4]
    Iz: jnp.ndarray        # second moment about z [mm^4] (== Iy for a tube)
    Ix: jnp.ndarray        # torsion constant J [mm^4] (= 2*Iy)
    Ay: jnp.ndarray        # shear area along y [mm^2] (= 0.5*Ax)
    Az: jnp.ndarray        # shear area along z [mm^2] (= 0.5*Ax)
    Wy: jnp.ndarray        # section modulus [mm^3]
    Wz: jnp.ndarray        # [mm^3]
    Wx: jnp.ndarray        # torsional modulus [mm^3]
    mass_per_m: jnp.ndarray  # [kg/m]
    D_t_ratio: jnp.ndarray   # thin-wall validity indicator (reference checks D/t > 10)


def tube_sections(D_outer_mm, t_mm, rho_steel=7850.0, dtype=None) -> TubeSections:
    """Build stacked tube section properties.

    Accepts scalars or 1-D arrays (all broadcast to a common ``[S]`` shape).
    Formulas are the classical thin/thick-wall annulus expressions used by the
    reference (`JacketAnalysisGUI_v2.py:122-137`): annular area, I = pi/64
    (D^4 - d^4), J = pi/32 (D^4 - d^4), shear areas = A/2.
    """
    D = jnp.atleast_1d(jnp.asarray(D_outer_mm, dtype=dtype))
    t = jnp.atleast_1d(jnp.asarray(t_mm, dtype=dtype))
    rho = jnp.atleast_1d(jnp.asarray(rho_steel, dtype=dtype))
    D, t, rho = jnp.broadcast_arrays(D, t, rho)
    dtype = D.dtype

    Di = D - 2.0 * t
    Ro = D / 2.0
    Ri = Di / 2.0
    Ax = jnp.pi / 4.0 * (D**2 - Di**2)
    Ax_m2 = Ax / 1e6
    Iy = jnp.pi / 64.0 * (D**4 - Di**4)
    Iz = Iy
    Ix = jnp.pi / 32.0 * (D**4 - Di**4)
    Ay = 0.5 * Ax
    Az = 0.5 * Ax
    Wy = Iy / Ro
    Wz = Iz / Ro
    Wx = Ix / Ro
    mass_per_m = Ax_m2 * rho
    return TubeSections(
        D_outer=D, t=t, rho_steel=rho, D_inner=Di, R_outer=Ro, R_inner=Ri,
        Ax=Ax, Ax_m2=Ax_m2, Iy=Iy, Iz=Iz, Ix=Ix, Ay=Ay, Az=Az,
        Wy=Wy, Wz=Wz, Wx=Wx, mass_per_m=mass_per_m, D_t_ratio=D / t,
    )


# The 8 circumferential stress evaluation points, 45 deg apart, at R_outer
# (reference ``get_stress_points``, `JacketAnalysisGUI_v2.py:139-145`).
STRESS_POINT_ANGLES_DEG = np.array([0.0, 45.0, 90.0, 135.0, 180.0, 225.0, 270.0, 315.0])


def stress_point_offsets(R_outer):
    """(y, z) offsets of the 8 stress points for radius ``R_outer``.

    Returns two arrays shaped ``R_outer.shape + (8,)``.
    """
    ang = jnp.deg2rad(jnp.asarray(STRESS_POINT_ANGLES_DEG, dtype=jnp.result_type(R_outer)))
    R = jnp.asarray(R_outer)[..., None]
    return R * jnp.cos(ang), R * jnp.sin(ang)


def normal_stress_8pt(sec: TubeSections, sect_id, Fx, My, Mz):
    """Axial + bending NORMAL stress at the 8 circumferential points.

    The linear-in-forces part of :func:`von_mises_8pt` (sigma = Fx/Ax +
    My z/Iy + Mz y/Iz), kept separate because frequency-domain response
    statistics need a LINEAR stress operator: the spectral moments of
    sigma(point) follow exactly from per-mode force coefficients, whereas
    the von Mises composition (sqrt of squares) does not superpose.  This
    is also the hot-spot stress convention of tubular-joint fatigue (SCFs
    multiply the nominal axial+bending stress, DNV RP-C203 practice);
    shear/torsion are excluded by convention there.

    Inputs ``[... , M]`` (N, N*mm); output ``[..., M, 8]`` in MPa.
    """
    y, z = stress_point_offsets(sec.R_outer[sect_id])
    return ((Fx / sec.Ax[sect_id])[..., None]
            + (My / sec.Iy[sect_id])[..., None] * z
            + (Mz / sec.Iz[sect_id])[..., None] * y)


def von_mises_8pt(sec: TubeSections, sect_id, Fx, Fy, Fz, Mx, My, Mz):
    """Max von Mises stress over the 8 circumferential points, batched.

    Vectorized equivalent of ``TubularSection.calc_stress_at_point``
    (`JacketAnalysisGUI_v2.py:147-160`) maximized over the 8 points as the
    reference solver does (`JacketAnalysisGUI_v2.py:514-519`):

      sigma = Fx/Ax + My*z/Iy + Mz*y/Iz
      tau   = sqrt((Mx*R/Ix)^2 + (Fy/Ay)^2 + (Fz/Az)^2)
      vm    = sqrt(sigma^2 + 3 tau^2)

    Inputs are arrays of shape ``[M]`` (forces in N, moments in N*mm);
    output ``[M]`` in MPa.
    """
    Axs = sec.Ax[sect_id]
    Iys = sec.Iy[sect_id]
    Izs = sec.Iz[sect_id]
    Ixs = sec.Ix[sect_id]
    Ays = sec.Ay[sect_id]
    Azs = sec.Az[sect_id]
    Ro = sec.R_outer[sect_id]

    y, z = stress_point_offsets(Ro)           # [M, 8]
    sigma = (Fx / Axs)[..., None] + (My / Iys)[..., None] * z + (Mz / Izs)[..., None] * y
    # R at every one of the 8 points is R_outer (y^2+z^2 = R_outer^2).
    # grad-safe sqrt (forward unchanged): sqrt's vjp at an exactly-zero
    # argument is NaN, which would poison end-to-end design gradients for
    # any member with zero shear+torsion
    def _safe_sqrt(x):
        pos = x > 0
        return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)

    tau = _safe_sqrt((Mx * Ro / Ixs) ** 2 + (Fy / Ays) ** 2 + (Fz / Azs) ** 2)
    vm = _safe_sqrt(sigma**2 + 3.0 * tau[..., None] ** 2)
    return jnp.max(vm, axis=-1)


def validate_sections(sec: TubeSections, strict: bool = False):
    """Thin-wall validity check D/t > 10 (the reference documents this limit
    in its Info tab, `JacketAnalysisGUI_v2.py:1574-1576`, but never enforces
    it).  Returns warning strings; raises if ``strict``."""
    import numpy as np
    msgs = []
    Dt = np.asarray(sec.D_t_ratio)
    D = np.asarray(sec.D_outer)
    for i in range(Dt.shape[0]):
        if Dt[i] <= 10.0:
            msgs.append(f"section {i} (D={D[i]:.0f} mm): D/t = {Dt[i]:.1f} "
                        f"<= 10 — thin-wall section formulas are inaccurate")
    if strict and msgs:
        raise ValueError("; ".join(msgs))
    return msgs
