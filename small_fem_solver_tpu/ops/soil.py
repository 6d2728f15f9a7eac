"""Pile-soil interaction: API RP 2A p-y / t-z / Q-z curves to pile-head
springs.

The reference excludes soil-structure interaction entirely (its Info tab,
`/root/reference/JacketAnalysisGUI_v2.py:1544-1799`; rigid clamps at
`:473-479`).  :func:`..api.analyze_ssi` already supports 6-DOF foundation
springs — this module computes those springs from actual geotechnical
data, the way a jacket designer gets them: a laterally and axially loaded
pile as a beam/rod on a NONLINEAR Winkler foundation, with the standard
API RP 2A-WSD (21st ed., section 6.8) soil resistance curves, solved by a
damped Newton iteration that is fully jitted (fixed iteration count,
static shapes) and runs in float64.

Soil resistance curves (per layer kind):

- ``sand`` (API 6.8.6-7 / Reese-Cox-Koop): ultimate
  ``p_u = min((C1 z + C2 D) gamma' z, C3 D gamma' z)`` with the C1/C2/C3
  wedge-flow coefficients evaluated from phi (alpha = phi/2,
  beta = 45 + phi/2, K0 = 0.4, Ka = tan^2(45 - phi/2)); mobilization
  ``p = A p_u tanh(k z y / (A p_u))`` with ``A = max(3 - 0.8 z/D, 0.9)``
  (static) and the initial modulus gradient ``k(phi)`` from the API chart
  for submerged sand (table-interpolated).
- ``clay`` (soft clay, Matlock 1970 / API 6.8.2-3): ultimate
  ``p_u = min(3 + gamma' z/s_u + J z/D, 9) s_u D``; static mobilization
  ``p/p_u = 0.5 (y/y_50)^(1/3)`` capped at 1.0, ``y_50 = 2.5 eps_50 D``
  (regularized to a linear segment below ``y/y_50 = 1e-3`` so the Newton
  Jacobian stays finite).
- ``linear`` — an elastic layer ``p = E_s y`` (verification against the
  closed-form beam-on-elastic-foundation solution, and a way to feed
  measured moduli directly).

Axial shaft/tip (API 6.7.2-3):

- clay skin ``t_max = alpha s_u`` with the API alpha method
  (``alpha = 0.5 psi^-0.5`` for ``psi = s_u/sigma'_v <= 1``, else
  ``0.5 psi^-0.25``, capped at 1); t-z mobilized by the API piecewise
  curve (peak at ``z/D = 0.01``, residual 0.9 beyond ``z/D = 0.02``).
- sand skin ``t_max = K sigma'_v tan(delta)`` with ``K = 0.8``,
  ``delta = phi - 5 deg``; bilinear t-z peaking at 2.54 mm.
- tip ``Q_max = 9 s_u A_tip`` (clay) or ``N_q sigma'_v A_tip`` (sand,
  ``N_q(phi)`` table), mobilized by the API Q-z curve (full at
  ``z/D = 0.10``); ``A_tip`` plugged (full circle) or unplugged (annulus).

Head stiffness: separate solves at the working loads give uncoupled
SECANT springs ``k_y = H/y(0)``, ``k_z = V/u(0)``, ``k_rot = M/theta(0)``
(cross-coupling H-M is dropped — :func:`..ops.solve.support_spring_nodes`
carries diagonal springs; the full 2x2 lateral tangent is also returned
for reporting).  Torsion uses the axial analogy elastically: distributed
skin stiffness ``s0 R^2`` (initial t-z secant) in the shaft equation gives
``K_t = sqrt(G J k_theta) tanh(L sqrt(k_theta / G J))``.

Units: soil input in engineering units (kPa, kN/m^3, m, mm); internal SI
(N, m); the returned springs are N/mm and N*mm/rad, ready for
``analyze_ssi`` / ``support_stiffness=``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

# API chart fits (host-side tables, interpolated at layer phi)
_K_SAND_PHI = np.array([20.0, 25.0, 30.0, 35.0, 40.0])       # deg
_K_SAND_MN3 = np.array([2.0, 5.4, 11.0, 22.0, 45.0])         # MN/m^3
_NQ_PHI = np.array([20.0, 25.0, 30.0, 35.0, 40.0])
_NQ = np.array([12.0, 20.0, 40.0, 50.0, 100.0])

# API t-z (clay) and Q-z piecewise curves, normalized (z/D, t/t_max)
_TZ_CLAY_Z = np.array([0.0, 0.0016, 0.0031, 0.0057, 0.0080, 0.0100,
                       0.0200, 1.0])
_TZ_CLAY_T = np.array([0.0, 0.30, 0.50, 0.75, 0.90, 1.00, 0.90, 0.90])
_QZ_Z = np.array([0.0, 0.002, 0.013, 0.042, 0.073, 0.100, 1.0])
_QZ_Q = np.array([0.0, 0.25, 0.50, 0.75, 0.90, 1.00, 1.00])


@dataclasses.dataclass(frozen=True)
class SoilLayer:
    """One soil layer, ``z_top <= z < z_bot`` in metres below mudline.

    ``kind``: 'sand' (phi_deg, gamma_kN_m3, optional k_MN_m3 override),
    'clay' (su_kPa, gamma_kN_m3, eps50, J) or 'linear' (Es_MPa lateral
    modulus, ks_MPa skin modulus, ktip_MN_m tip spring).
    """

    kind: str
    z_top: float
    z_bot: float
    gamma_kN_m3: float = 10.0     # effective (submerged) unit weight
    phi_deg: float = 30.0         # sand friction angle
    k_MN_m3: float | None = None  # sand initial modulus gradient override
    su_kPa: float = 50.0          # clay undrained shear strength
    eps50: float = 0.01           # clay strain at half ultimate
    J: float = 0.5                # Matlock empirical constant
    Es_MPa: float | None = None   # linear lateral modulus (p = Es y)
    ks_MPa: float | None = None   # linear skin modulus (t' = ks u)
    ktip_MN_m: float = 0.0        # linear tip spring

    def __post_init__(self):
        if self.kind not in ("sand", "clay", "linear"):
            raise ValueError("SoilLayer kind must be 'sand', 'clay' or "
                             f"'linear' (got {self.kind!r})")
        if self.z_bot <= self.z_top:
            raise ValueError("SoilLayer needs z_bot > z_top")
        if self.kind == "linear" and self.Es_MPa is None:
            raise ValueError("linear SoilLayer needs Es_MPa")


@dataclasses.dataclass(frozen=True)
class Pile:
    """Tubular pile below the mudline (the jacket model owns any stickup)."""

    D_mm: float
    t_mm: float
    L_m: float
    E_MPa: float = 210000.0
    nu: float = 0.3
    n_elem: int = 64
    plugged: bool = True

    def __post_init__(self):
        if self.L_m <= 0 or self.D_mm <= 0 or self.t_mm <= 0:
            raise ValueError("Pile needs positive D_mm, t_mm, L_m")
        if self.n_elem < 4:
            raise ValueError("Pile needs n_elem >= 4")


def _sand_C123(phi_deg):
    """Reese-Cox-Koop wedge/flow coefficients (API RP 2A commentary).

    Hand anchors: phi = 30 deg -> C1 ~ 1.9, C2 ~ 2.7, C3 ~ 28.
    """
    phi = np.deg2rad(phi_deg)
    a = phi / 2.0
    b = np.deg2rad(45.0) + phi / 2.0
    K0, Ka = 0.4, np.tan(np.deg2rad(45.0) - phi / 2.0) ** 2
    C1 = (np.tan(b) ** 2 * np.tan(a) / np.tan(b - phi)
          + K0 * (np.tan(phi) * np.sin(b) / (np.cos(a) * np.tan(b - phi))
                  + np.tan(b) * (np.tan(phi) * np.sin(b) - np.tan(a))))
    C2 = np.tan(b) / np.tan(b - phi) - Ka
    C3 = Ka * (np.tan(b) ** 8 - 1.0) + K0 * np.tan(phi) * np.tan(b) ** 4
    return C1, C2, C3


def _layer_at(soil: Sequence[SoilLayer], z: np.ndarray) -> list[SoilLayer]:
    """The layer owning each depth (last layer extends to the pile tip)."""
    out = []
    for zi in z:
        hit = None
        for lay in soil:
            if lay.z_top <= zi < lay.z_bot:
                hit = lay
                break
        out.append(hit if hit is not None else soil[-1])
    return out


def _overburden(soil: Sequence[SoilLayer], z: np.ndarray) -> np.ndarray:
    """Effective vertical stress sigma'_v [Pa] at each depth."""
    sig = np.zeros_like(z)
    for i, zi in enumerate(z):
        s = 0.0
        for lay in soil:
            lo = max(lay.z_top, 0.0)
            hi = min(lay.z_bot, zi)
            if hi > lo:
                s += lay.gamma_kN_m3 * 1e3 * (hi - lo)
        # depth beyond the last layer: extend the deepest layer
        deepest = max(lay.z_bot for lay in soil)
        if zi > deepest:
            s += soil[-1].gamma_kN_m3 * 1e3 * (zi - deepest)
        sig[i] = s
    return sig


class _LateralParams(NamedTuple):
    """Per-node p-y parameters (SI): see py_resistance."""

    kind: jnp.ndarray     # int32: 0 sand, 1 clay, 2 linear
    pu: jnp.ndarray       # ultimate resistance [N/m]
    c1: jnp.ndarray       # sand: A pu & k z | clay: y50 | linear: Es
    c2: jnp.ndarray       # sand: k z [N/m^2]


def _lateral_params(pile: Pile, soil: Sequence[SoilLayer], z: np.ndarray,
                    scour_m: float = 0.0) -> _LateralParams:
    """Per-node p-y parameters.

    Depth-strength products use the TRUE integrated overburden sigma'_v
    (the API uniform-soil forms ``gamma' z`` generalize to sigma'_v in
    layered profiles: ``(C1 z + C2 D) gamma' z = (C1 z + C2 D) sigma'_v``)
    and the geometric depth measured from the SCOURED mudline
    (``z_eff = z - scour_m``); nodes inside the scour hole carry no soil.
    Layer identity stays tied to the original (survey) depth ``z``.
    """
    D = pile.D_mm / 1000.0
    layers = _layer_at(soil, z)
    sig = _overburden(soil, z) - _overburden(soil,
                                             np.full_like(z, scour_m))
    sig = np.maximum(sig, 0.0)                           # sigma'_v [Pa]
    z_eff = z - scour_m
    kind = np.zeros(len(z), np.int32)
    pu = np.zeros(len(z))
    c1 = np.zeros(len(z))
    c2 = np.zeros(len(z))
    for i, (zi, lay) in enumerate(zip(z_eff, layers)):
        if lay.kind == "sand":
            kind[i] = 0
            if zi < 0.0:
                continue  # inside the scour hole                                  # scoured away
            C1, C2, C3 = _sand_C123(lay.phi_deg)
            pu_i = min((C1 * zi + C2 * D) * sig[i], C3 * D * sig[i])
            A = max(3.0 - 0.8 * zi / D, 0.9)
            k = (lay.k_MN_m3 if lay.k_MN_m3 is not None
                 else float(np.interp(lay.phi_deg, _K_SAND_PHI,
                                      _K_SAND_MN3))) * 1e6   # N/m^3
            pu[i] = A * pu_i                              # A pu [N/m]
            c2[i] = k * zi                                # N/m^2
        elif lay.kind == "clay":
            kind[i] = 1
            if zi < 0.0:
                continue  # inside the scour hole
            su = lay.su_kPa * 1e3
            pu[i] = min(3.0 + sig[i] / su + lay.J * zi / D, 9.0) * su * D
            c1[i] = 2.5 * lay.eps50 * D                   # y50 [m]
        else:
            kind[i] = 2
            c1[i] = lay.Es_MPa * 1e6 if zi >= 0.0 else 0.0  # Pa
    return _LateralParams(jnp.asarray(kind), jnp.asarray(pu),
                          jnp.asarray(c1), jnp.asarray(c2))


def py_resistance(par: _LateralParams, y):
    """Soil resistance p(y) [N/m] per node — odd in y, branchless, with a
    well-defined positive dp/dy at y = 0 (the Newton iteration starts
    there, so sign(y)*p(|y|) forms would zero the soil Jacobian and leave
    the free-free beam matrix singular).

    sand: A pu tanh(k z y / (A pu)); clay: 0.5 pu (y/y50)^(1/3) capped at
    pu, linearized below |y|/y50 = 1e-3; linear: Es y.
    """
    # sand (pu field already holds A*pu); tanh is odd and smooth
    pu_safe = jnp.where(par.pu > 0, par.pu, 1.0)
    p_sand = jnp.where(par.pu > 0,
                       par.pu * jnp.tanh(par.c2 * y / pu_safe), 0.0)
    # clay: odd cube-root with linear core.  Double-where guards the
    # |y|^(1/3) gradient (inf at 0) from leaking NaN through the where.
    y50 = jnp.where(par.c1 > 0, par.c1, 1.0)
    r = y / y50
    r0 = 1e-3
    small = jnp.abs(r) < r0
    r_safe = jnp.where(small, r0, r)
    p_pow = jnp.sign(r_safe) * jnp.minimum(
        0.5 * jnp.abs(r_safe) ** (1.0 / 3.0), 1.0)
    p_linseg = 0.5 * r0 ** (-2.0 / 3.0) * r
    p_clay = par.pu * jnp.where(small, p_linseg, p_pow)
    # linear
    p_lin = par.c1 * y
    return jnp.where(par.kind == 0, p_sand,
                     jnp.where(par.kind == 1, p_clay, p_lin))


def _beam_matrix(EI: float, L: float, n: int) -> np.ndarray:
    """[2(n+1) x 2(n+1)] Euler-Bernoulli lateral stiffness, DOFs (y, th)."""
    le = L / n
    k = EI / le**3 * np.array([
        [12.0, 6 * le, -12.0, 6 * le],
        [6 * le, 4 * le**2, -6 * le, 2 * le**2],
        [-12.0, -6 * le, 12.0, -6 * le],
        [6 * le, 2 * le**2, -6 * le, 4 * le**2]])
    K = np.zeros((2 * (n + 1), 2 * (n + 1)))
    for e in range(n):
        K[2 * e:2 * e + 4, 2 * e:2 * e + 4] += k
    return K


def _rod_matrix(EA: float, L: float, n: int) -> np.ndarray:
    le = L / n
    K = np.zeros((n + 1, n + 1))
    for e in range(n):
        K[e:e + 2, e:e + 2] += EA / le * np.array([[1.0, -1.0], [-1.0, 1.0]])
    return K


def _trib(L: float, n: int) -> np.ndarray:
    l = np.full(n + 1, L / n)
    l[0] = l[-1] = L / (2 * n)
    return l


class PileSolve(NamedTuple):
    """Converged Winkler solution (SI units)."""

    u: jnp.ndarray          # lateral: [2(n+1)] (y, th) | axial: [n+1]
    residual: jnp.ndarray   # |R| / (|F| + 1) at the last Newton step
    z: np.ndarray           # node depths [m]


def _newton(K, F, soil_force, soil_jac, n_iter: int = 60):
    """Newton on R(u) = K u + f_soil(u) - F (f64, fixed count).

    Not wrapped in jax.jit (the soil closures capture traced arrays) —
    lax.fori_loop compiles the body regardless, and this is a
    once-per-design setup path, not a per-phase hot loop.  The tangent J
    is NOT guaranteed SPD (plastic p-y plateaus zero the soil diagonal),
    so the solve is LU.
    """
    def body(_, u):
        R = K @ u + soil_force(u) - F
        J = K + soil_jac(u)
        du = jnp.linalg.solve(J, R)
        return u - du

    u = jax.lax.fori_loop(0, n_iter, body, jnp.zeros_like(F))
    R = K @ u + soil_force(u) - F
    return u, jnp.linalg.norm(R) / (jnp.linalg.norm(F) + 1.0)


def lateral_solve(pile: Pile, soil: Sequence[SoilLayer], H_N: float,
                  M_Nm: float = 0.0, n_iter: int = 60,
                  scour_m: float = 0.0) -> PileSolve:
    """Laterally loaded pile: head shear ``H_N`` [N] and moment ``M_Nm``
    [N m] at the (original) mudline; returns nodal (y [m], theta [rad]).
    ``scour_m``: general scour depth — the top metres carry no soil and
    all depth/overburden terms are measured from the scoured surface."""
    n = pile.n_elem
    D = pile.D_mm / 1000.0
    Di = (pile.D_mm - 2 * pile.t_mm) / 1000.0
    EI = pile.E_MPa * 1e6 * np.pi / 64.0 * (D**4 - Di**4)
    z = np.linspace(0.0, pile.L_m, n + 1)
    par = _lateral_params(pile, soil, z, scour_m=scour_m)
    trib = jnp.asarray(_trib(pile.L_m, n))
    K = jnp.asarray(_beam_matrix(EI, pile.L_m, n))
    F = jnp.zeros(2 * (n + 1), jnp.float64).at[0].set(H_N).at[1].set(M_Nm)

    p_node = lambda y: py_resistance(par, y) * trib
    dp_node = jax.vmap(jax.grad(
        lambda yi, i: (py_resistance(
            jax.tree.map(lambda a: a[i], par), yi)
            * trib[i])), in_axes=(0, 0))
    idx = jnp.arange(n + 1)

    def soil_force(u):
        f = jnp.zeros_like(u)
        return f.at[0::2].set(p_node(u[0::2]))

    def soil_jac(u):
        d = jnp.zeros_like(u)
        d = d.at[0::2].set(dp_node(u[0::2], idx))
        return jnp.diag(d)

    u, res = _newton(K, F, soil_force, soil_jac, n_iter=n_iter)
    return PileSolve(u=u, residual=res, z=z)


class _AxialParams(NamedTuple):
    kind: jnp.ndarray    # 0 sand, 1 clay, 2 linear
    tmax: jnp.ndarray    # ultimate shaft transfer per length [N/m]
    scale: jnp.ndarray   # clay: D | sand: z_peak | linear: ks


def _axial_params(pile: Pile, soil: Sequence[SoilLayer], z: np.ndarray,
                  scour_m: float = 0.0) -> tuple[_AxialParams, float, float]:
    """Per-node t-z parameters + (Q_max [N], D [m]); scour removes skin
    in the hole and reduces the overburden everywhere below."""
    D = pile.D_mm / 1000.0
    circ = np.pi * D
    layers = _layer_at(soil, z)
    sig = np.maximum(_overburden(soil, z)
                     - _overburden(soil, np.full_like(z, scour_m)), 0.0)
    z_eff = z - scour_m
    kind = np.zeros(len(z), np.int32)
    tmax = np.zeros(len(z))
    scale = np.zeros(len(z))
    for i, (zi, lay) in enumerate(zip(z_eff, layers)):
        if lay.kind == "sand":
            kind[i] = 0
            if zi < 0.0:
                continue  # inside the scour hole
            delta = np.deg2rad(max(lay.phi_deg - 5.0, 5.0))
            tmax[i] = 0.8 * sig[i] * np.tan(delta) * circ
            scale[i] = 0.00254                        # peak at 2.54 mm
        elif lay.kind == "clay":
            kind[i] = 1
            if zi < 0.0:
                continue  # inside the scour hole
            su = lay.su_kPa * 1e3
            psi = su / max(sig[i], 1.0)
            alpha = min(0.5 * psi**-0.5 if psi <= 1.0 else 0.5 * psi**-0.25,
                        1.0)
            tmax[i] = alpha * su * circ
            scale[i] = D
        else:
            kind[i] = 2
            scale[i] = ((lay.ks_MPa or 0.0) * 1e6 if zi >= 0.0
                        else 0.0)                     # N/m per m
    # tip
    tip = layers[-1]
    if pile.plugged:
        A_tip = np.pi / 4.0 * D**2
    else:
        A_tip = np.pi / 4.0 * (D**2 - ((pile.D_mm - 2 * pile.t_mm)
                                       / 1000.0)**2)
    if tip.kind == "clay":
        Q_max = 9.0 * tip.su_kPa * 1e3 * A_tip
    elif tip.kind == "sand":
        Nq = float(np.interp(tip.phi_deg, _NQ_PHI, _NQ))
        Q_max = Nq * sig[-1] * A_tip
    else:
        Q_max = 0.0
    return (_AxialParams(jnp.asarray(kind), jnp.asarray(tmax),
                         jnp.asarray(scale)), Q_max, D)


# odd extension of the clay t-z table so dt/du is positive AT u = 0
_TZ_CLAY_Z_ODD = np.concatenate([-_TZ_CLAY_Z[:0:-1], _TZ_CLAY_Z])
_TZ_CLAY_T_ODD = np.concatenate([-_TZ_CLAY_T[:0:-1], _TZ_CLAY_T])


def tz_resistance(par: _AxialParams, u):
    """Shaft transfer t(u) [N/m] per node — odd in u, branchless, positive
    dt/du at u = 0 (same Newton-at-zero requirement as py_resistance)."""
    # sand: bilinear to 2.54 mm (clip is odd and has slope 1 at 0)
    t_sand = par.tmax * jnp.clip(u / 0.00254, -1.0, 1.0)
    # clay: API piecewise on z/D (residual 0.9), odd-extended table
    r = u / jnp.where(par.scale > 0, par.scale, 1.0)
    t_clay = par.tmax * jnp.interp(r, jnp.asarray(_TZ_CLAY_Z_ODD),
                                   jnp.asarray(_TZ_CLAY_T_ODD))
    t_lin = par.scale * u
    return jnp.where(par.kind == 0, t_sand,
                     jnp.where(par.kind == 1, t_clay, t_lin))


def axial_solve(pile: Pile, soil: Sequence[SoilLayer], V_N: float,
                n_iter: int = 60, scour_m: float = 0.0) -> PileSolve:
    """Axially loaded pile (positive ``V_N`` = compression, head settles
    +u); nonlinear t-z shaft + Q-z tip; ``scour_m`` as lateral_solve."""
    n = pile.n_elem
    D = pile.D_mm / 1000.0
    Di = (pile.D_mm - 2 * pile.t_mm) / 1000.0
    EA = pile.E_MPa * 1e6 * np.pi / 4.0 * (D**2 - Di**2)
    z = np.linspace(0.0, pile.L_m, n + 1)
    par, Q_max, _ = _axial_params(pile, soil, z, scour_m=scour_m)
    trib = jnp.asarray(_trib(pile.L_m, n))
    # linear-layer tip spring (if the tip layer is linear)
    tip_lay = _layer_at(soil, np.array([pile.L_m]))[0]
    ktip_lin = (tip_lay.ktip_MN_m or 0.0) * 1e6 if tip_lay.kind == "linear" \
        else 0.0
    K = jnp.asarray(_rod_matrix(EA, pile.L_m, n))
    F = jnp.zeros(n + 1, jnp.float64).at[0].set(V_N)

    qz_z = jnp.asarray(_QZ_Z)
    qz_q = jnp.asarray(_QZ_Q)

    def tip_force(ut):
        if Q_max > 0.0:
            # tip resists compression (downward u > 0) only
            return Q_max * jnp.interp(jnp.maximum(ut, 0.0) / D, qz_z, qz_q)
        return ktip_lin * ut

    def soil_force(u):
        f = tz_resistance(par, u) * trib
        return f.at[-1].add(tip_force(u[-1]))

    dt_node = jax.vmap(jax.grad(
        lambda ui, i: (tz_resistance(
            jax.tree.map(lambda a: a[i], par), ui) * trib[i])),
        in_axes=(0, 0))
    idx = jnp.arange(n + 1)

    def soil_jac(u):
        d = dt_node(u, idx)
        d = d.at[-1].add(jax.grad(tip_force)(u[-1]))
        return jnp.diag(d)

    u, res = _newton(K, F, soil_force, soil_jac, n_iter=n_iter)
    return PileSolve(u=u, residual=res, z=z)


class PileHeadStiffness(NamedTuple):
    """Secant pile-head springs at the working loads (see module doc)."""

    support_stiffness: np.ndarray   # [6] N/mm & N*mm/rad (diagonal secants)
    K_lateral_2x2: np.ndarray       # [[H/y, H/th],[M/y, M/th]] secant info
    y_head_mm: float                # lateral head deflection at H_work
    theta_head_rad: float
    u_head_mm: float                # axial settlement at V_work
    residuals: np.ndarray           # [3] Newton residuals (H, M, V solves)


def pile_head_stiffness(pile: Pile, soil: Sequence[SoilLayer],
                        H_kN: float = 100.0, V_kN: float = 1000.0,
                        M_kNm: float = 0.0,
                        scour_m: float = 0.0) -> PileHeadStiffness:
    """Uncoupled secant pile-head springs at the given working loads.

    Three nonlinear solves (H alone, M alone — default the H-solve's
    fixed-head moment scale 0.5 H L_char, V alone) give
    ``k = load / head displacement``; torsion comes from the elastic axial
    analogy.  Feed the result's ``support_stiffness`` to
    :func:`..api.analyze_ssi` (or :func:`soil_support_stiffness` for
    per-support working loads from a clamped analysis).
    """
    if H_kN <= 0 or V_kN <= 0:
        raise ValueError("pile_head_stiffness needs H_kN > 0 and V_kN > 0 "
                         "working loads (probe with small values if unknown)")
    H = H_kN * 1e3
    V = V_kN * 1e3
    lat_H = lateral_solve(pile, soil, H, 0.0, scour_m=scour_m)
    y0 = float(lat_H.u[0])
    th_H = float(lat_H.u[1])
    if M_kNm <= 0.0:
        # probe moment at a characteristic lever: a jacket leg's fixed-head
        # pile attracts M ~ H x (a few diameters)
        M = H * min(5.0 * pile.D_mm / 1000.0, pile.L_m / 4.0)
    else:
        M = M_kNm * 1e3
    lat_M = lateral_solve(pile, soil, 0.0, M, scour_m=scour_m)
    th0 = float(lat_M.u[1])
    ax = axial_solve(pile, soil, V, scour_m=scour_m)
    u0 = float(ax.u[0])

    ky = H / max(abs(y0), 1e-12)                       # N/m
    krot = M / max(abs(th0), 1e-12)                    # N m/rad
    kz = V / max(abs(u0), 1e-12)                       # N/m

    # torsion: elastic shaft with distributed skin stiffness s0 R^2
    D = pile.D_mm / 1000.0
    Di = (pile.D_mm - 2 * pile.t_mm) / 1000.0
    G = pile.E_MPa * 1e6 / (2.0 * (1.0 + pile.nu))
    J = np.pi / 32.0 * (D**4 - Di**4)
    z = np.linspace(0.0, pile.L_m, pile.n_elem + 1)
    par, _, _ = _axial_params(pile, soil, z, scour_m=scour_m)
    u_probe = 0.001
    s0 = np.asarray(tz_resistance(par, jnp.full(len(z), u_probe))) / u_probe
    k_theta = float(np.mean(s0)) * (D / 2.0) ** 2      # N m/rad per m
    if k_theta > 0:
        mu = np.sqrt(k_theta / (G * J))
        kt = np.sqrt(G * J * k_theta) * np.tanh(mu * pile.L_m)
    else:
        kt = G * J / pile.L_m
    ks = np.array([ky / 1e3, ky / 1e3, kz / 1e3,       # N/m -> N/mm
                   krot * 1e3, krot * 1e3, kt * 1e3])  # N m -> N mm
    K2 = np.array([[H / max(abs(y0), 1e-12), H / max(abs(th_H), 1e-12)],
                   [M / max(abs(float(lat_M.u[0])), 1e-12),
                    M / max(abs(th0), 1e-12)]])
    return PileHeadStiffness(
        support_stiffness=ks, K_lateral_2x2=K2,
        y_head_mm=y0 * 1e3, theta_head_rad=th0, u_head_mm=u0 * 1e3,
        residuals=np.array([float(lat_H.residual), float(lat_M.residual),
                            float(ax.residual)]))


def soil_support_stiffness(model, soil: Sequence[SoilLayer], pile: Pile,
                           reactions=None,
                           scour_m: float = 0.0) -> np.ndarray:
    """Per-support [n_fixed, 6] springs from per-support working loads.

    ``reactions``: the clamped analysis' ``results.reactions`` (N / N*mm on
    the fixed nodes) — each support's pile is solved at ITS working shear /
    axial force / moment.  None uses one shared 100 kN / 1000 kN probe.
    The standard workflow: clamped ``analyze`` -> this -> ``analyze_ssi``
    (one fixed-point round is usually enough; iterate for soft soils).
    """
    fixed = np.where(np.asarray(model.fixed_mask))[0]
    out = np.zeros((fixed.size, 6))
    for i in range(fixed.size):
        if reactions is None:
            H_kN, V_kN, M_kNm = 100.0, 1000.0, 0.0
        else:
            # results.reactions is [n_fixed, 6] (support rows only)
            R = np.asarray(reactions).reshape(-1, 6)[i]
            H_kN = max(float(np.hypot(R[0], R[1])) / 1e3, 10.0)
            V_kN = max(abs(float(R[2])) / 1e3, 100.0)
            M_kNm = max(float(np.hypot(R[3], R[4])) / 1e6, 0.0)
        head = pile_head_stiffness(pile, soil, H_kN=H_kN, V_kN=V_kN,
                                   M_kNm=M_kNm if M_kNm > 1.0 else 0.0,
                                   scour_m=scour_m)
        out[i] = head.support_stiffness
    return out
