"""Modal analysis: consistent mass matrices and natural frequencies.

A capability upgrade beyond the reference, which explicitly excludes
dynamics (`/root/reference/JacketAnalysisGUI_v2.py` Info tab: "no dynamics")
— yet natural periods are the first thing a jacket designer checks against
the wave period to rule out resonance.  Implemented with the same batched
tensor style as the statics: stacked consistent element mass matrices
(classical Euler-Bernoulli translational + axial + torsional terms,
Przemieniecki form), congruence-transformed and assembled exactly like K,
then a symmetric generalized eigenproblem

    K phi = omega^2 M phi   ->   (L_M^-1 K L_M^-T) y = omega^2 y

via the Cholesky factor of M_ff — all jnp, so it runs jitted on the device
(f64 on the CPU for validation).

Unit system: K is N/mm, displacements mm / rad, so M carries tonnes
(1 t = 1 N s^2/mm) and t*mm^2 for rotary terms; omega comes out in rad/s.
"""
from __future__ import annotations

from typing import NamedTuple

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .beams import element_stiffness, local_axes, transformation_matrices
from .sections import TubeSections


def _build_mass_patterns():
    """Constant 12x12 patterns: M_local = rho A L * P0 + rho Ix L * P1
    + rho A L * L * P2 + rho A L * L^2 * P3   (bending terms split by their
    L power so the contraction stays one matmul)."""
    P = np.zeros((4, 12, 12))

    def sym(c, i, j, v):
        P[c, i, j] += v
        if i != j:
            P[c, j, i] += v

    # axial (dofs 0, 6) and torsion (3, 9): (1/6)[[2,1],[1,2]]
    for c, (i, j) in [(0, (0, 6)), (1, (3, 9))]:
        sym(c, i, i, 2.0 / 6.0)
        sym(c, j, j, 2.0 / 6.0)
        sym(c, i, j, 1.0 / 6.0)

    # bending in local y (v=1, theta_z=5 | v=7, theta_z=11), /420
    b = 1.0 / 420.0
    sym(0, 1, 1, 156 * b); sym(0, 7, 7, 156 * b); sym(0, 1, 7, 54 * b)
    sym(2, 1, 5, 22 * b); sym(2, 7, 11, -22 * b)
    sym(2, 1, 11, -13 * b); sym(2, 5, 7, 13 * b)
    sym(3, 5, 5, 4 * b); sym(3, 11, 11, 4 * b); sym(3, 5, 11, -3 * b)

    # bending in local z (w=2, theta_y=4 | w=8, theta_y=10); theta_y = -w'
    sym(0, 2, 2, 156 * b); sym(0, 8, 8, 156 * b); sym(0, 2, 8, 54 * b)
    sym(2, 2, 4, -22 * b); sym(2, 8, 10, 22 * b)
    sym(2, 2, 10, 13 * b); sym(2, 4, 8, -13 * b)
    sym(3, 4, 4, 4 * b); sym(3, 10, 10, 4 * b); sym(3, 4, 10, -3 * b)
    return P.reshape(4, 144)


_MPAT = _build_mass_patterns()


def _build_lateral_mass_patterns():
    """Transverse-only consistent mass patterns (the two local bending
    planes, no axial/torsion): added mass acts perpendicular to a slender
    member, not along it."""
    P = np.zeros((3, 12, 12))

    def sym(c, i, j, v):
        P[c, i, j] += v
        if i != j:
            P[c, j, i] += v

    b = 1.0 / 420.0
    # local y translations/rotations (v = 1, 7; theta_z = 5, 11)
    sym(0, 1, 1, 156 * b); sym(0, 7, 7, 156 * b); sym(0, 1, 7, 54 * b)
    sym(1, 1, 5, 22 * b); sym(1, 7, 11, -22 * b)
    sym(1, 1, 11, -13 * b); sym(1, 5, 7, 13 * b)
    sym(2, 5, 5, 4 * b); sym(2, 11, 11, 4 * b); sym(2, 5, 11, -3 * b)
    # local z translations/rotations (w = 2, 8; theta_y = 4, 10)
    sym(0, 2, 2, 156 * b); sym(0, 8, 8, 156 * b); sym(0, 2, 8, 54 * b)
    sym(1, 2, 4, -22 * b); sym(1, 8, 10, 22 * b)
    sym(1, 2, 10, 13 * b); sym(1, 4, 8, -13 * b)
    sym(2, 4, 4, 4 * b); sym(2, 10, 10, 4 * b); sym(2, 4, 10, -3 * b)
    return P.reshape(3, 144)


_MPAT_LAT = _build_lateral_mass_patterns()


def element_added_mass(coords, conn, D_m, rho_water=1025.0, Ca=1.0):
    """Hydrodynamic ADDED mass matrices [M, 12, 12] (tonnes).

    The Morison inertia force on a MOVING member carries a
    rho Ca (pi D^2/4) term proportional to the structure's own
    acceleration — the added mass that every submerged-structure dynamic
    analysis must include (it lengthens jacket periods by ~5-15%).  The
    reference excludes dynamics entirely; the round-2 dynamics tier used
    structural + topside mass only.

    Transverse-only consistent formulation (added mass acts perpendicular
    to a slender cylinder; the axial/torsional terms are ~zero), scaled by
    each member's STILL-WATER wetted length fraction (z < 0; the
    time-varying wetted band is a second-order effect on the mass matrix).
    ``Ca`` is the added-mass coefficient (Cm - 1; 1.0 for a cylinder,
    matching the default Cm = 2).
    """
    c1 = coords[conn[:, 0]]
    c2 = coords[conn[:, 1]]
    dL = c2 - c1
    L = jnp.linalg.norm(dL, axis=-1)              # m
    L_mm = L * 1000.0
    dtype = coords.dtype

    # still-water wetted fraction from the end elevations
    z1, z2 = c1[:, 2], c2[:, 2]
    zlo = jnp.minimum(z1, z2)
    zhi = jnp.maximum(z1, z2)
    span = jnp.maximum(zhi - zlo, 1e-12)
    frac = jnp.clip((0.0 - zlo) / span, 0.0, 1.0)
    frac = jnp.where(zhi - zlo < 1e-9, (zhi < 0.0).astype(dtype), frac)

    # rho Ca pi D^2/4 [kg/m] -> [t/mm]
    ma = (rho_water * Ca * jnp.pi * D_m**2 / 4.0) * 1e-6 * frac
    mL = ma * L_mm                                # t per element
    coeffs = jnp.stack([mL, mL * L_mm, mL * L_mm**2], axis=-1)
    pat = jnp.asarray(_MPAT_LAT, dtype=dtype)
    M_local = (coeffs @ pat).reshape(-1, 12, 12)

    R = local_axes(dL, L)
    T = transformation_matrices(R)
    return jnp.einsum("mji,mjk,mkl->mil", T, M_local, T)


def element_hydro_damping(coords, conn, c_damp):
    """Consistent transverse HYDRODYNAMIC DAMPING matrices [M, 12, 12].

    ``c_damp``: per-member linearized drag-damping coefficient per unit
    length [N s/m per m] (Borgman: 0.5 rho Cd D sqrt(8/pi) sigma_v,
    wetted-masked and member-averaged — see
    :func:`.freqdomain.linearized_sea_loads`).  Same transverse consistent
    pattern as :func:`element_added_mass` (drag acts perpendicular to a
    slender cylinder); units convert to the FEM's N, mm, s system
    (velocity mm/s -> coefficient N s/mm per mm = SI x 1e-6)."""
    c1 = coords[conn[:, 0]]
    c2 = coords[conn[:, 1]]
    dL = c2 - c1
    L = jnp.linalg.norm(dL, axis=-1)              # m
    L_mm = L * 1000.0
    dtype = coords.dtype

    cu = jnp.asarray(c_damp, dtype) * 1e-6        # N s/mm per mm
    cL = cu * L_mm                                # N s/mm per element
    coeffs = jnp.stack([cL, cL * L_mm, cL * L_mm**2], axis=-1)
    pat = jnp.asarray(_MPAT_LAT, dtype=dtype)
    C_local = (coeffs @ pat).reshape(-1, 12, 12)

    R = local_axes(dL, L)
    T = transformation_matrices(R)
    return jnp.einsum("mji,mjk,mkl->mil", T, C_local, T)


def element_mass(coords, conn, sec: TubeSections, sect_id):
    """Stacked global-frame consistent mass matrices [M, 12, 12] (tonnes)."""
    c1 = coords[conn[:, 0]]
    c2 = coords[conn[:, 1]]
    dL = c2 - c1
    L = jnp.linalg.norm(dL, axis=-1)              # m
    L_mm = L * 1000.0
    dtype = coords.dtype

    rho_t = sec.rho_steel[sect_id] * 1e-12        # t/mm^3
    A = sec.Ax[sect_id]                           # mm^2
    Ix = sec.Ix[sect_id]                          # mm^4
    mAL = rho_t * A * L_mm                        # t
    mIx = rho_t * Ix * L_mm                       # t mm^2

    coeffs = jnp.stack([mAL, mIx, mAL * L_mm, mAL * L_mm**2], axis=-1)
    pat = jnp.asarray(_MPAT, dtype=dtype)
    M_local = (coeffs @ pat).reshape(-1, 12, 12)

    R = local_axes(dL, L)
    T = transformation_matrices(R)
    return jnp.einsum("mji,mjk,mkl->mil", T, M_local, T)


class ModalResults(NamedTuple):
    frequencies_hz: jnp.ndarray    # [n_modes]
    omega: jnp.ndarray             # [n_modes] rad/s
    periods_s: jnp.ndarray         # [n_modes]
    mode_shapes: jnp.ndarray       # [n_modes, n_dof] (zeros at fixed DOFs
                                   #  when clamped; nonzero there on springs)
    total_mass_t: jnp.ndarray      # structural mass [tonnes]


def _build_km(model, E, nu, topside_mass_t, added_mass_Ca=None,
              rho_water=1025.0):
    """Assembled (K, M, free-dof array, member lengths) shared by the modal
    and harmonic-response paths (single source for the topside-mass lumping
    and the hydrodynamic added mass)."""
    from .assembly import assemble_dense
    from .morison import hydro_diameter_m
    from .solve import free_fixed_dofs

    G = E / (2.0 * (1.0 + nu))
    Kg, K_local, T, L_m = element_stiffness(model.coords, model.conn,
                                            model.sections, model.sect_id,
                                            E, G, release=model.release)
    Mg = element_mass(model.coords, model.conn, model.sections, model.sect_id)
    if added_mass_Ca is not None:
        D_m = hydro_diameter_m(model.sections, model.sect_id)
        Mg = Mg + element_added_mass(model.coords, model.conn, D_m,
                                     rho_water=rho_water, Ca=added_mass_Ca)
    K = assemble_dense(Kg, model.conn, model.n_dof)
    M = assemble_dense(Mg, model.conn, model.n_dof)
    if topside_mass_t:
        top = np.where(np.asarray(model.top_mask))[0]
        per = topside_mass_t / max(len(top), 1)
        for i in top:
            for c in range(3):
                M = M.at[6 * i + c, 6 * i + c].add(per)
    free, _ = free_fixed_dofs(model.fixed_mask)
    return K, M, jnp.asarray(free), (K_local, T, L_m)


def _eigh_backend(method: str = "auto") -> str:
    """'lapack' (full jnp.linalg.eigh: LAPACK on the CPU, cuSOLVER on the
    GPU) or 'subspace' (Bathe iteration, ops/eigen.py).  'auto' is the
    full eigh on every backend; 'subspace' stays selectable (written for
    an accelerator without eigh; kept until measured on the GPU)."""
    return "lapack" if method == "auto" else method


def _modal_from_ff(K_ff, M_ff, free, n_dof, n_modes, dtype,
                   method: str = "auto"):
    """Lowest generalized eigenpairs of (K_ff, M_ff), expanded to full-DOF
    mode shapes.  ``method='subspace'`` solves by Cholesky + matmuls + a
    small Jacobi eigh (written for an accelerator without `jnp.linalg.eigh`;
    kept until measured on the GPU); measured 4.6e-11 relative eigenvalue
    agreement vs LAPACK at 8 iterations on the default jacket, we run
    16."""
    if _eigh_backend(method) == "subspace":
        from .eigen import subspace_eigh
        w2, phi_f = subspace_eigh(K_ff, M_ff, n_modes, n_iter=16)
        omega = jnp.sqrt(jnp.clip(w2, 0.0))
        shapes = jnp.zeros((n_modes, n_dof), dtype=dtype)
        return omega, shapes.at[:, free].set(phi_f.T)
    Lm = jnp.linalg.cholesky(M_ff)
    Y = jax.scipy.linalg.solve_triangular(Lm, K_ff, lower=True)
    A = jax.scipy.linalg.solve_triangular(Lm, Y.T, lower=True)
    A = 0.5 * (A + A.T)
    w2, V = jnp.linalg.eigh(A)
    w2 = jnp.clip(w2[:n_modes], 0.0)
    omega = jnp.sqrt(w2)
    phi_f = jax.scipy.linalg.solve_triangular(Lm.T, V[:, :n_modes],
                                              lower=False)
    shapes = jnp.zeros((n_modes, n_dof), dtype=dtype)
    return omega, shapes.at[:, free].set(phi_f.T)


def modal_analysis(model, n_modes: int = 10, E: float = 210000.0,
                   nu: float = 0.3, topside_mass_t: float = 0.0,
                   support_stiffness=None,
                   added_mass_Ca=None, rho_water: float = 1025.0) -> ModalResults:
    """Natural frequencies/mode shapes of the (supported) structure.

    ``topside_mass_t`` lumps an optional deck mass equally onto the top
    nodes' translational DOFs — the dominant dynamic effect for jackets.
    ``support_stiffness`` (a [6] or [n_fixed, 6] spring vector, N/mm and
    N*mm/rad, as in :func:`api.analyze_ssi`) replaces the rigid support
    clamp with foundation springs: the eigenproblem is solved over ALL
    DOFs with ``K + diag(k)``, so foundation flexibility lengthens the
    natural periods — the first-order SSI effect on jacket dynamics.
    ``added_mass_Ca`` (e.g. 1.0 = the default Cm - 1) adds the
    hydrodynamic added mass of the wetted members
    (:func:`element_added_mass`) — submerged structures vibrate with the
    entrained water, lengthening the periods.
    Dense path (fine to a few thousand DOF).
    """
    dtype = model.coords.dtype
    with jax.default_matmul_precision("highest"):
        K, M, free, (_, _, L_m) = _build_km(model, E, nu, topside_mass_t,
                                            added_mass_Ca, rho_water)
        if support_stiffness is not None:
            from .solve import ground_with_springs
            K, free = ground_with_springs(K, model.fixed_mask,
                                          support_stiffness, dtype)
        K_ff = K[jnp.ix_(free, free)]
        M_ff = M[jnp.ix_(free, free)]
        omega, shapes = _modal_from_ff(K_ff, M_ff, free, model.n_dof,
                                       n_modes, dtype)

    mass_per_m = model.sections.mass_per_m[model.sect_id]
    total_mass = jnp.sum(mass_per_m * L_m) / 1000.0 + topside_mass_t
    return ModalResults(
        frequencies_hz=omega / (2.0 * jnp.pi),
        omega=omega,
        periods_s=jnp.where(omega > 0, 2.0 * jnp.pi / omega, jnp.inf),
        mode_shapes=shapes,
        total_mass_t=total_mass,
    )


def _chain_blocks(Xe, n_seg):
    """Split member-major element matrices [Mc*n_seg, 12, 12] into chain
    blocks (A, B, C, E) of shape [Mc, n_seg, 6, 6]."""
    Mc = Xe.shape[0] // n_seg
    X = Xe.reshape(Mc, n_seg, 12, 12)
    return (X[:, :, 0:6, 0:6], X[:, :, 0:6, 6:12],
            X[:, :, 6:12, 0:6], X[:, :, 6:12, 6:12])


@partial(jax.jit, static_argnames=("n_seg",))
def _chain_dense(A, B, C, E, n_seg):
    """Dense per-chain interior operator and interface coupling.

    Returns (X_ii [Mc, 6 n_int, 6 n_int], X_ib [Mc, 6 n_int, 12],
    X_bb [Mc, 12, 12]) for a chain-structured matrix given its element
    blocks; n_int = n_seg - 1 (static, so the Python loop unrolls).

    jitted ON PURPOSE: eagerly, each `.at[].set` update copies the full
    [Mc, N, N] buffer — measured ~60 s of pure memcpy at n_seg = 100 (and
    unbounded growth at 327).  The three block diagonals are placed with
    ONE vectorized scatter each, so the compile stays O(1) in n_seg.
    """
    Mc = A.shape[0]
    n_int = n_seg - 1
    N = 6 * n_int
    dtype = A.dtype
    p = np.arange(n_int)
    r6 = np.arange(6)
    rows = 6 * p[:, None, None] + r6[None, :, None]     # [n_int, 6, 6]
    cols = 6 * p[:, None, None] + r6[None, None, :]
    X_ii = jnp.zeros((Mc, N, N), dtype)
    # interior node p+1 joins elements p, p+1
    X_ii = X_ii.at[:, rows, cols].set(E[:, :n_int] + A[:, 1:n_int + 1])
    if n_int > 1:
        X_ii = X_ii.at[:, rows[:-1], cols[1:]].set(B[:, 1:n_int])
        X_ii = X_ii.at[:, rows[1:], cols[:-1]].set(C[:, 1:n_int])
    X_ib = jnp.zeros((Mc, N, 12), dtype)
    X_ib = X_ib.at[:, 0:6, 0:6].set(C[:, 0])
    X_ib = X_ib.at[:, N - 6:N, 6:12].set(B[:, -1])
    X_bb = jnp.zeros((Mc, 12, 12), dtype)
    X_bb = X_bb.at[:, 0:6, 0:6].set(A[:, 0])
    X_bb = X_bb.at[:, 6:12, 6:12].set(E[:, -1])
    return X_ii, X_ib, X_bb


import dataclasses


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CBReduction:
    """Craig-Bampton reduction of a chain-refined jacket (see
    :func:`modal_analysis_condensed`).

    A pytree with STATIC dimension metadata (n_red/nc/Mc/m), so the
    reduction can flow through jit/shard_map and its dims still build
    shapes (`_cb_expand` slices with them)."""

    K_red: jnp.ndarray      # [n_red, n_red]
    M_red: jnp.ndarray      # [n_red, n_red]
    free: jnp.ndarray       # free reduced DOFs (fixed coarse nodes clamped)
    Psi: jnp.ndarray        # [Mc, N, 12] constraint modes
    Phi: jnp.ndarray        # [Mc, N, m] fixed-interface modes
    bdof: jnp.ndarray       # [Mc, 12] interface DOF ids per member
    qdof: jnp.ndarray       # [Mc, m] generalized DOF ids per member
    L_m: jnp.ndarray        # [Mr] refined member lengths
    K_local: jnp.ndarray    # [Mr, 12, 12] for stress recovery
    T: jnp.ndarray          # [Mr, 12, 12]
    # static:
    n_red: int = dataclasses.field(metadata=dict(static=True))
    nc: int = dataclasses.field(metadata=dict(static=True))
    Mc: int = dataclasses.field(metadata=dict(static=True))
    m: int = dataclasses.field(metadata=dict(static=True))


def _cb_reduce(coarse, refined, n_seg: int, E: float, nu: float,
               topside_mass_t: float, n_chain_modes: int,
               support_stiffness=None, added_mass_Ca=None,
               rho_water: float = 1025.0) -> CBReduction:
    """Build the reduced (K, M) and the member transformation blocks."""
    from .assembly import assemble_dense
    from .morison import hydro_diameter_m
    from .solve import free_fixed_dofs

    dtype = refined.coords.dtype
    G = E / (2.0 * (1.0 + nu))
    with jax.default_matmul_precision("highest"):
        Kg, K_local, T, L_m = element_stiffness(
            refined.coords, refined.conn, refined.sections, refined.sect_id,
            E, G, release=refined.release)
        Mg = element_mass(refined.coords, refined.conn, refined.sections,
                          refined.sect_id)
        if added_mass_Ca is not None:
            D_m = hydro_diameter_m(refined.sections, refined.sect_id)
            Mg = Mg + element_added_mass(refined.coords, refined.conn, D_m,
                                         rho_water=rho_water,
                                         Ca=added_mass_Ca)
        MA, MB, MC, ME = _chain_blocks(Mg, n_seg)
        Mc = Mg.shape[0] // n_seg
        nc = coarse.n_nodes
        n_int = n_seg - 1
        N_chain = 6 * n_int
        m = min(n_chain_modes, N_chain)

        # ------------------------------------------------------------------
        # MATRIX-FREE chain Craig-Bampton (round 4): the interior operators
        # are block-TRIDIAGONAL along each chain, so nothing [Mc, N, N]
        # dense is ever formed.  The block-Thomas factorization
        # (ops/condense.py::factor_chains — the battle-tested static
        # condensation) directly provides the constraint modes
        # (Psi = [-Z0 | -Zn]) and the condensed interface stiffness
        # (K_super = K_bb_r); the fixed-interface modes come from Bathe
        # subspace iteration whose K-solves are the O(N) chain sweeps and
        # whose mass applications are banded matvecs.  This replaced dense
        # [51, 1956, 1956] f64 operators that cost ~200 s on CPU and
        # exhausted compile memory at the 100k-DOF mesh.
        # ------------------------------------------------------------------
        from .condense import condense_loads, factor_chains
        from .eigen import eigh_general_small

        fac = factor_chains(Kg, n_seg)
        K_bb_r = fac.K_super                             # [Mc, 12, 12]
        Z0m = jnp.moveaxis(fac.Z0, 0, 1).reshape(Mc, N_chain, 6)
        Znm = jnp.moveaxis(fac.Zn, 0, 1).reshape(Mc, N_chain, 6)
        Psi = -jnp.concatenate([Z0m, Znm], axis=-1)      # [Mc, N, 12]

        # banded interior mass operator (same block layout as _chain_dense)
        DM = ME[:, :-1] + MA[:, 1:]                      # [Mc, n_int, 6, 6]
        UM = MB[:, 1:n_int]                              # (row p, col p+1)
        LM = MC[:, 1:n_int]                              # (row p+1, col p)

        def mass_mv(Vk):
            """M_ii V for V [k, n_int, Mc, 6] (the chain-sweep layout)."""
            Vm = jnp.moveaxis(Vk, 2, 1)                  # [k, Mc, n_int, 6]
            y = jnp.einsum("mpij,kmpj->kmpi", DM, Vm)
            if n_int > 1:
                y = y.at[:, :, :-1].add(
                    jnp.einsum("mpij,kmpj->kmpi", UM, Vm[:, :, 1:]))
                y = y.at[:, :, 1:].add(
                    jnp.einsum("mpij,kmpj->kmpi", LM, Vm[:, :, :-1]))
            return jnp.moveaxis(y, 1, 2)

        # fixed-interface normal modes: per-chain subspace iteration (chain
        # spectra separate like i^2 / i^4, so 10 iterations with a m/2
        # guard block reach LAPACK agreement — tests/test_eigen.py)
        msub = min(m + max(4, m // 2), N_chain)
        if msub >= N_chain:
            # SHORT chains (the guard block would span the whole interior
            # space): one dense Rayleigh-Ritz on the full space is exact
            # and avoids the inverse iteration entirely.  This matters for
            # more than cost — the iteration's Gram matrix W^T M W has the
            # SQUARE of the pencil's condition number, which NaN'd the f32
            # production dtype at n_seg=2 (cond ~2e8); the direct pencil is
            # only ~1e4 and f32-accurate.  Dense [Mc, N, N] is tiny here.
            KA, KB, KC, KE = _chain_blocks(Kg, n_seg)
            K_ii, _, _ = _chain_dense(KA, KB, KC, KE, n_seg)
            M_ii, _, _ = _chain_dense(MA, MB, MC, ME, n_seg)
            lam, Phi_f = eigh_general_small(K_ii, M_ii)
            lam = jnp.clip(lam[:, :m], 0.0)
            Phi = Phi_f[:, :, :m]                        # [Mc, N, m]
        else:
            kk = jnp.arange(1, msub + 1, dtype=dtype)
            pos = jnp.arange(1, N_chain + 1, dtype=dtype)
            V0 = jnp.sin(kk[:, None] * pos[None, :] * 2.399963)
            V0 = jnp.broadcast_to(V0[:, None, :], (msub, Mc, N_chain))
            Vk = jnp.moveaxis(V0.reshape(msub, Mc, n_int, 6), 2, 1)

            def one_it(_, carry):
                Vk, lam = carry
                MV = mass_mv(Vk)
                W = condense_loads(fac, MV)[2]           # K_ii^-1 M V
                MW = mass_mv(W)
                Ar = jnp.einsum("apmi,bpmi->mab", W, MV)  # = W^T K W
                Br = jnp.einsum("apmi,bpmi->mab", W, MW)
                Ar = 0.5 * (Ar + jnp.swapaxes(Ar, -1, -2))
                Br = 0.5 * (Br + jnp.swapaxes(Br, -1, -2))
                lam, Q = eigh_general_small(Ar, Br)
                Vk = jnp.einsum("apmi,mab->bpmi", W, Q)  # M-orthonormal
                return Vk, lam

            lam0 = jnp.zeros((Mc, msub), dtype)
            Vk, lam = jax.lax.fori_loop(0, 10, one_it, (Vk, lam0))
            lam = jnp.clip(lam[:, :m], 0.0)
            # (k, p, m, i) -> (m, p, i, k) -> [Mc, N, m]
            Phi = Vk[:m].transpose(2, 1, 3, 0).reshape(Mc, N_chain, m)

        # reduced member blocks, all through the banded mass operator and
        # the SPARSE interface coupling (M_ib has only two 6x6 blocks:
        # (rows 0:6, cols 0:6) = MC[:, 0] and (rows N-6:, cols 6:12)
        # = MB[:, -1]; M_bb is block-diag(MA[:, 0], ME[:, -1]))
        # (m, p, i, c) -> (c, p, m, i): the 12 interface columns ride the
        # batch axis of the banded matvec
        Psi_k = Psi.reshape(Mc, n_int, 6, 12).transpose(3, 1, 0, 2)
        # (c, p, m, i) -> (m, p, i, c) -> [Mc, N, 12]
        MPsi = mass_mv(Psi_k).transpose(2, 1, 3, 0) \
            .reshape(Mc, N_chain, 12)

        def mib_t(X):
            """M_ib^T X for X [Mc, N, c] -> [Mc, 12, c]."""
            top = jnp.einsum("mij,mic->mjc", MC[:, 0], X[:, :6])
            bot = jnp.einsum("mij,mic->mjc", MB[:, -1], X[:, N_chain - 6:])
            return jnp.concatenate([top, bot], axis=1)

        mibT_psi = mib_t(Psi)                            # [Mc, 12, 12]
        M_bb = jnp.zeros((Mc, 12, 12), dtype)
        M_bb = M_bb.at[:, :6, :6].set(MA[:, 0])
        M_bb = M_bb.at[:, 6:, 6:].set(ME[:, -1])
        M_bb_r = M_bb + mibT_psi + jnp.swapaxes(mibT_psi, -1, -2) \
            + jnp.einsum("mnc,mnd->mcd", Psi, MPsi)
        M_bq = mib_t(Phi) + jnp.einsum("mnc,mnq->mcq", MPsi, Phi)

        # global reduced assembly: interface DOFs + per-member mode DOFs
        n_red = 6 * nc + Mc * m
        K_red = jnp.zeros((n_red, n_red), dtype)
        M_red = jnp.zeros((n_red, n_red), dtype)
        K_red = K_red.at[:6 * nc, :6 * nc].set(
            assemble_dense(K_bb_r, coarse.conn, 6 * nc))
        M_red = M_red.at[:6 * nc, :6 * nc].set(
            assemble_dense(M_bb_r, coarse.conn, 6 * nc))
        qdof = 6 * nc + jnp.arange(Mc * m).reshape(Mc, m)
        K_red = K_red.at[qdof.reshape(-1), qdof.reshape(-1)].set(
            lam.reshape(-1))
        M_red = M_red.at[qdof.reshape(-1), qdof.reshape(-1)].set(1.0)
        bdof = jnp.concatenate([6 * coarse.conn[:, 0:1] + jnp.arange(6),
                                6 * coarse.conn[:, 1:2] + jnp.arange(6)],
                               axis=-1)                  # [Mc, 12]
        M_red = M_red.at[bdof[:, :, None], qdof[:, None, :]].add(M_bq)
        M_red = M_red.at[qdof[:, :, None], bdof[:, None, :]].add(
            jnp.swapaxes(M_bq, -1, -2))

        if topside_mass_t:
            top = np.where(np.asarray(coarse.top_mask))[0]
            per = topside_mass_t / max(len(top), 1)
            for i in top:
                for c in range(3):
                    M_red = M_red.at[6 * i + c, 6 * i + c].add(per)

        # boundary conditions: clamp fixed coarse nodes (all q DOFs free) —
        # or, with foundation springs, ground through diag(k) on the
        # support interface DOFs and free EVERY reduced DOF
        if support_stiffness is not None:
            from .solve import support_spring_nodes
            ks = support_spring_nodes(coarse.fixed_mask, support_stiffness)
            idx = jnp.arange(6 * nc)      # springs live on interface DOFs
            K_red = K_red.at[idx, idx].add(
                jnp.asarray(ks.reshape(-1), dtype))
            free = jnp.arange(n_red)
        else:
            free_b, _ = free_fixed_dofs(coarse.fixed_mask)
            free = jnp.concatenate([jnp.asarray(free_b),
                                    6 * nc + jnp.arange(Mc * m)])
    return CBReduction(K_red=K_red, M_red=M_red, free=free, Psi=Psi,
                       Phi=Phi, bdof=bdof, qdof=qdof, n_red=n_red, nc=nc,
                       Mc=Mc, m=m, L_m=L_m, K_local=K_local, T=T)


def _cb_expand(cb: CBReduction, shapes_r):
    """Expand reduced-coordinate vectors [..., n_red] to the refined mesh
    layout [..., n_dof_refined] (v = Psi u_b + Phi q per member)."""
    lead = shapes_r.shape[:-1]
    u_b = shapes_r[..., :6 * cb.nc]
    q = shapes_r[..., 6 * cb.nc:].reshape(*lead, cb.Mc, cb.m)
    ub_e = u_b[..., cb.bdof.reshape(-1)].reshape(*lead, cb.Mc, 12)
    v = jnp.einsum("mnj,...mj->...mn", cb.Psi, ub_e) \
        + jnp.einsum("mnq,...mq->...mn", cb.Phi, q)    # [..., Mc, N]
    return jnp.concatenate([u_b, v.reshape(*lead, -1)], axis=-1)


def modal_analysis_condensed(coarse, refined, n_seg: int, n_modes: int = 10,
                             E: float = 210000.0, nu: float = 0.3,
                             topside_mass_t: float = 0.0,
                             n_chain_modes: int = 12,
                             support_stiffness=None, added_mass_Ca=None,
                             rho_water: float = 1025.0) -> ModalResults:
    """Craig-Bampton reduced modal analysis for chain-refined jackets.

    The dense path (:func:`modal_analysis`) is O(n^3) on the full refined
    DOF count and caps out at a few thousand DOF.  Here every member chain
    is reduced to its 12 interface DOFs (constraint modes = the exact static
    condensation) plus its ``n_chain_modes`` lowest fixed-interface normal
    modes — the classical Craig-Bampton (1968) superelement — all batched
    over members.  The reduced eigenproblem has
    ``6 n_coarse_nodes + Mc * n_chain_modes`` DOF (738 for the default
    jacket at any refinement with 12 modes/chain) regardless of n_seg.

    Retained-mode rule of thumb: global modes converge rapidly below the
    lowest truncated chain frequency; with 16 modes/chain the first ~12
    jacket modes match the dense solution to ~1e-6 at n_seg=8
    (tests/test_dynamics.py).
    """
    dtype = refined.coords.dtype
    cb = _cb_reduce(coarse, refined, n_seg, E, nu, topside_mass_t,
                    n_chain_modes, support_stiffness=support_stiffness,
                    added_mass_Ca=added_mass_Ca, rho_water=rho_water)
    with jax.default_matmul_precision("highest"):
        K_ff = cb.K_red[jnp.ix_(cb.free, cb.free)]
        M_ff = cb.M_red[jnp.ix_(cb.free, cb.free)]
        omega, shapes_r = _modal_from_ff(K_ff, M_ff, cb.free, cb.n_red,
                                         n_modes, dtype)
        shapes = _cb_expand(cb, shapes_r)
        # interior layout: member-major [Mc, n_int, 6] == refine_model order

    mass_per_m = refined.sections.mass_per_m[refined.sect_id]
    total_mass = jnp.sum(mass_per_m * cb.L_m) / 1000.0 + topside_mass_t
    return ModalResults(
        frequencies_hz=omega / (2.0 * jnp.pi),
        omega=omega,
        periods_s=jnp.where(omega > 0, 2.0 * jnp.pi / omega, jnp.inf),
        mode_shapes=shapes,
        total_mass_t=total_mass,
    )


def dynamic_response_condensed(coarse, refined, n_seg: int, wave, case,
                               n_harmonics: int = 6,
                               damping_ratio: float = 0.02,
                               n_steps: int = 72, n_gauss: int = 15,
                               topside_mass_t: float | None = None,
                               n_chain_modes: int = 12,
                               support_stiffness=None,
                               added_mass_Ca=None) -> "HarmonicResponse":
    """Steady-state dynamic response of a REFINED jacket on the
    Craig-Bampton reduced basis.

    Same physics as :func:`dynamic_response` (Fourier-decomposed Morison
    loading incl. drag super-harmonics, Rayleigh damping, complex harmonic
    solves) but the harmonic systems live in the refinement-independent
    reduced space (interface DOFs + chain modes), so meshes far beyond the
    dense ~3k-DOF cap run in seconds.  Loads are evaluated on the FULL
    refined mesh and projected with the CB transformation (the work-
    conjugate reduction), and responses are expanded back for full-field
    stress recovery.
    """
    from ..api import assemble_loads
    from .beams import matmul12, matvec12
    from .morison import morison_phase_batch
    from .sections import von_mises_8pt

    dtype = refined.coords.dtype
    case = case.cast(dtype)
    if topside_mass_t is None:
        topside_mass_t = float(case.custom_sw_tonnes)
    cb = _cb_reduce(coarse, refined, n_seg, float(case.E), float(case.nu),
                    topside_mass_t, n_chain_modes,
                    support_stiffness=support_stiffness,
                    added_mass_Ca=added_mass_Ca,
                    rho_water=float(case.rho_water))
    nc, Mc = cb.nc, cb.Mc

    with jax.default_matmul_precision("highest"):
        K_ff = cb.K_red[jnp.ix_(cb.free, cb.free)]
        M_ff = cb.M_red[jnp.ix_(cb.free, cb.free)]
        omega_n, _ = _modal_from_ff(K_ff, M_ff, cb.free, cb.n_red, 6, dtype)
    omega_np = np.asarray(omega_n)
    w1 = float(omega_np[0])
    w2 = next((float(w) for w in omega_np[1:] if w > 1.01 * w1), 3.0 * w1)
    alpha = damping_ratio * 2.0 * w1 * w2 / (w1 + w2)
    beta = damping_ratio * 2.0 / (w1 + w2)

    if case.slam_cs:
        raise ValueError("dynamics loading uses the separable phase "
                         "matmul; slamming (slam_cs > 0) is pointwise-"
                         "path only")
    from .morison import hydro_members
    conn_hx, D_mx, Cd_hx, Cm_hx = hydro_members(
        refined, case.marine_growth_mm, case.Cd, case.Cm)
    # post-calibration pipeline is ONE jitted program (see
    # _dynamic_core_dense for the eager-dispatch cost it avoids)
    return _dynamic_core_condensed(
        cb, refined, wave, case, K_ff, M_ff, conn_hx, D_mx, Cd_hx, Cm_hx,
        alpha, beta, n_h=min(n_harmonics, n_steps // 2), n_steps=n_steps,
        n_gauss=n_gauss, n_seg=n_seg)


@partial(jax.jit, static_argnames=("n_h", "n_steps", "n_gauss", "n_seg"))
def _dynamic_core_condensed(cb, refined, wave, case, K_ff, M_ff,
                            conn_hcd, D_mcd, Cd_hcd, Cm_hcd, alpha, beta,
                            n_h: int, n_steps: int, n_gauss: int,
                            n_seg: int):
    """The post-calibration half of :func:`dynamic_response_condensed`,
    compiled."""
    from ..api import assemble_loads
    from .beams import matmul12, matvec12
    from .morison import morison_phase_batch
    from .sections import von_mises_8pt

    dtype = refined.coords.dtype
    nc, Mc = cb.nc, cb.Mc
    with jax.default_matmul_precision("highest"):
        # loads over one period on the refined mesh, projected to CB space
        ts = jnp.arange(n_steps, dtype=dtype) * wave.T / n_steps
        conn_h, D_m, Cd_h, Cm_h = conn_hcd, D_mcd, Cd_hcd, Cm_hcd
        mb = morison_phase_batch(wave, refined.coords, conn_h, D_m,
                                 case.wave_dir_deg, case.current_dir_deg,
                                 Cd_h, Cm_h, case.rho_water, ts,
                                 n_gauss=n_gauss)
        F = jax.vmap(lambda nodal: assemble_loads(
            refined, case, nodal, cb.L_m))(mb.nodal_forces)  # [S, n_dof_ref]
        Fn = F.reshape(n_steps, -1, 6)
        F_b = Fn[:, :nc].reshape(n_steps, -1)                # [S, 6 nc]
        n_int = n_seg - 1
        F_i = Fn[:, nc:].reshape(n_steps, Mc, n_int * 6)     # [S, Mc, N]
        F_red = jnp.zeros((n_steps, cb.n_red), dtype)
        F_red = F_red.at[:, :6 * nc].set(F_b)
        F_red = F_red.at[:, cb.bdof].add(
            jnp.einsum("mnj,smn->smj", cb.Psi, F_i))
        F_red = F_red.at[:, cb.qdof].add(
            jnp.einsum("mnq,smn->smq", cb.Phi, F_i))
        F_f = F_red[:, cb.free]

        # real one-sided DFT + real-pair harmonic solves (written for an
        # accelerator without FFT, LU or complex dtypes; kept until
        # measured on the GPU)
        c_re, c_im = real_dft_coeffs(F_f, n_h)

        omega = wave.omega.astype(dtype)
        U_re, U_im = harmonic_solve_real(K_ff, M_ff, c_re, c_im, omega,
                                         alpha, beta)
        LKs, dKs = _chol_scaled(K_ff)
        Us_re = _cho_solve_scaled(LKs, dKs, c_re.T).T
        Us_im = _cho_solve_scaled(LKs, dKs, c_im.T).T

        def reconstruct(U_r, U_i):
            u = real_harmonic_reconstruct(U_r, U_i, omega, ts).astype(dtype)
            U_red = jnp.zeros((n_steps, cb.n_red), dtype)
            U_red = U_red.at[:, cb.free].set(u)
            return _cb_expand(cb, U_red)                 # [S, n_dof_ref]

        U_time = reconstruct(U_re, U_im)
        U_static = reconstruct(Us_re, Us_im)

        KT6 = -matmul12(cb.K_local, cb.T)[:, :6, :]
        dofs = jnp.concatenate([6 * refined.conn[:, 0:1] + jnp.arange(6),
                                6 * refined.conn[:, 1:2] + jnp.arange(6)],
                               axis=-1)

        def util_of(U):
            F1 = matvec12(KT6, U[:, dofs])
            vm = von_mises_8pt(refined.sections, refined.sect_id,
                               F1[..., 0], F1[..., 1], F1[..., 2],
                               F1[..., 3], F1[..., 4], F1[..., 5])
            return vm / case.fy

        disp = lambda U: jnp.max(jnp.linalg.norm(
            U.reshape(n_steps, -1, 6)[:, :, :3], axis=-1))
        return HarmonicResponse(
            ts=ts, U_time=U_time, U_static=U_static,
            utilization=util_of(U_time),
            utilization_static=util_of(U_static),
            daf=disp(U_time) / jnp.maximum(disp(U_static), 1e-30),
            omega=omega,
            rayleigh_alpha=jnp.asarray(alpha, dtype),
            rayleigh_beta=jnp.asarray(beta, dtype),
        )


class TransientResponse(NamedTuple):
    """Direct time integration on the Craig-Bampton reduced basis."""

    ts: jnp.ndarray               # [S] sample times
    U_time: jnp.ndarray           # [S, n_dof_ref] displacements (mm/rad)
    utilization: jnp.ndarray      # [S, M_ref] von Mises utilization
    tip_displacement_mm: jnp.ndarray  # [S] max nodal translation per step
    omega1: jnp.ndarray           # first natural frequency [rad/s]
    rayleigh_alpha: jnp.ndarray
    rayleigh_beta: jnp.ndarray


def _cb_reduce_forces(cb: CBReduction, F, nc, n_seg, dtype):
    """Work-conjugate projection of full-mesh load vectors [..., n_dof_ref]
    to CB coordinates [..., n_red]."""
    lead = F.shape[:-1]
    Fn = F.reshape(*lead, -1, 6)
    F_b = Fn[..., :nc, :].reshape(*lead, -1)
    n_int = n_seg - 1
    F_i = Fn[..., nc:, :].reshape(*lead, cb.Mc, n_int * 6)
    F_red = jnp.zeros((*lead, cb.n_red), dtype)
    F_red = F_red.at[..., :6 * nc].set(F_b)
    F_red = F_red.at[..., cb.bdof].add(
        jnp.einsum("mnj,...mn->...mj", cb.Psi, F_i))
    F_red = F_red.at[..., cb.qdof].add(
        jnp.einsum("mnq,...mn->...mq", cb.Phi, F_i))
    return F_red


def _cb_reduced_loads(cb: CBReduction, refined, case, nodal_forces, nc,
                      n_seg, dtype):
    """Project full-mesh nodal force batches [S, n, 3] to CB coordinates
    [S, n_red] (work-conjugate reduction), including interface/self-weight
    terms via assemble_loads."""
    from ..api import assemble_loads

    F = jax.vmap(lambda nodal: assemble_loads(
        refined, case, nodal, cb.L_m))(nodal_forces)       # [S, n_dof_ref]
    return _cb_reduce_forces(cb, F, nc, n_seg, dtype)


def _relative_drag_fn(refined, case, wave, n_gauss, stretching, dtype):
    """Per-step relative-velocity Morison drag evaluator.

    Returns ``drag_at(t, v_nodal) -> nodal [n, 3] N`` with
    ``U_rel = U_wave + U_current - v_structure`` (``v_nodal`` in m/s) —
    the standard relative formulation whose velocity-coupled term IS the
    hydrodynamic (viscous) drag damping.  Mirrors :func:`.morison.
    morison_loads`' drag term exactly at v = 0 (uniform current, analytic
    acceleration path); the wave may be a FourierWave, a long-crested
    SpectralSea, or None (still water: drag from structural motion alone —
    free-decay damping).
    """
    from .morison import gauss_legendre_01, hydro_members
    from .spectrum import SpectralSea, sea_kinematics
    from .waves import kinematics as wave_kinematics

    conn_h, D_m, Cd_h, Cm_h = hydro_members(refined, case.marine_growth_mm,
                                            case.Cd, case.Cm)
    theta_w = jnp.deg2rad(jnp.asarray(90.0 - case.wave_dir_deg, dtype=dtype))
    theta_c = jnp.deg2rad(jnp.asarray(90.0 - case.current_dir_deg,
                                      dtype=dtype))
    cos_w, sin_w = jnp.cos(theta_w), jnp.sin(theta_w)
    cos_c, sin_c = jnp.cos(theta_c), jnp.sin(theta_c)
    coords = refined.coords
    c1 = coords[conn_h[:, 0]]
    c2 = coords[conn_h[:, 1]]
    dL = c2 - c1
    L = jnp.linalg.norm(dL, axis=-1)
    e = dL / L[:, None]
    s, w = gauss_legendre_01(n_gauss)
    s = jnp.asarray(s, dtype=dtype)
    w = jnp.asarray(w, dtype=dtype)
    pos = c1[:, None, :] + s[None, :, None] * dL[:, None, :]   # [Mh, Q, 3]
    x_wave = pos[..., 0] * cos_w + pos[..., 1] * sin_w
    z = pos[..., 2]
    Cd = jnp.asarray(Cd_h, dtype=dtype)
    if Cd.ndim == 1:
        Cd = Cd[:, None]
    D = D_m[:, None]
    Lw = L[:, None] * w[None, :]
    rho = case.rho_water
    n_nodes = coords.shape[0]
    nodes = jnp.concatenate([conn_h[:, 0], conn_h[:, 1]])

    if isinstance(wave, SpectralSea) and wave.dir_deg is not None:
        raise ValueError("relative_drag supports long-crested seas only "
                         "(spread seas resolve per-mode headings in the "
                         "precomputed batch, not pointwise)")

    def drag_at(t, v_nodal):
        if wave is None:                                   # still water
            sub = z <= 0.0
            subf = sub.astype(dtype)
            U = jnp.zeros_like(pos)
        else:
            if isinstance(wave, SpectralSea):
                kin = sea_kinematics(wave, x_wave, z,
                                     jnp.asarray(t, dtype=dtype))
            else:
                kin = wave_kinematics(wave, x_wave, z,
                                      jnp.asarray(t, dtype=dtype),
                                      accel="analytic", stretching=stretching)
            sub = kin.submerged
            subf = sub.astype(dtype)
            u_wave_only = kin.u - wave.U_c * subf
            U = jnp.stack([
                u_wave_only * cos_w + wave.U_c * subf * cos_c,
                u_wave_only * sin_w + wave.U_c * subf * sin_c,
                kin.w,
            ], axis=-1)                                    # [Mh, Q, 3]
        v1 = v_nodal[conn_h[:, 0]]
        v2 = v_nodal[conn_h[:, 1]]
        v_pt = (1.0 - s)[None, :, None] * v1[:, None, :] \
            + s[None, :, None] * v2[:, None, :]
        U_rel = U - v_pt * subf[..., None]
        eb = e[:, None, :]
        U_perp = U_rel - jnp.sum(U_rel * eb, axis=-1, keepdims=True) * eb
        U_sq = jnp.sum(U_perp * U_perp, axis=-1)
        U_mag = jnp.where(U_sq > 0,
                          jnp.sqrt(jnp.where(U_sq > 0, U_sq, 1.0)), 0.0)
        drag_on = jnp.logical_and(sub, U_mag > 1e-10).astype(dtype)
        f = (0.5 * rho * Cd * D * U_mag * Lw)[..., None] * U_perp \
            * drag_on[..., None]
        F1 = jnp.sum((1.0 - s)[None, :, None] * f, axis=1)
        F2 = jnp.sum(s[None, :, None] * f, axis=1)
        contrib = jnp.concatenate([F1, F2], axis=0)
        return jax.ops.segment_sum(contrib, nodes, num_segments=n_nodes)

    return drag_at


def transient_response_condensed(coarse, refined, n_seg: int, wave, case,
                                 dt: float, n_steps: int,
                                 damping_ratio: float = 0.02,
                                 n_gauss: int = 15,
                                 topside_mass_t: float | None = None,
                                 n_chain_modes: int = 12,
                                 support_stiffness=None,
                                 ramp_periods: float = 0.0,
                                 u0=None, zero_loads: bool = False,
                                 stretching: str = "none",
                                 added_mass_Ca=None,
                                 relative_drag: bool = False,
                                 drag_iterations: int = 1,
                                 ground_accel=None,
                                 ground_dir=(1.0, 0.0, 0.0),
                                 newmark=(0.25, 0.5)) -> TransientResponse:
    """Transient (direct time-integration) response on the Craig-Bampton
    reduced basis — Newmark-beta, unconditionally stable average
    acceleration by default.

    Completes the dynamics tier the frequency-domain solvers cannot cover:
    ramp-up/decay transients, irregular-sea (``wave`` may be a
    :class:`.spectrum.SpectralSea`) time histories, and free decay.  All
    arithmetic is REAL, as in :func:`dynamic_response_condensed`'s
    realified harmonic solves: the reduced
    effective matrix (K + a0 M + a1 C) is Cholesky-factored ONCE and the
    time march is a ``lax.scan`` of multiplies + one triangular solve per
    step.  Loads for ALL steps are evaluated up front through the separable
    Morison batch (one matmul) and projected to the reduced basis.

    ``ramp_periods`` linearly ramps the loading over that many wave (or
    peak) periods to suppress the startup transient; ``u0`` (full refined
    displacement vector, e.g. a static solution or a scaled mode shape)
    sets the initial state; ``zero_loads=True`` integrates free
    vibration/decay.  Rayleigh damping is calibrated to ``damping_ratio``
    at the first two distinct natural frequencies, exactly as the harmonic
    solvers do.

    ``relative_drag=True`` switches the drag term to the relative-velocity
    Morison formulation F_d ~ |U - v| (U - v): the velocity-coupled part
    is the physical hydrodynamic (viscous) damping — amplitude-dependent,
    quadratic, and absent from both the reference and the Rayleigh model.
    The wave inertia loads stay precomputed (one matmul); only the drag is
    evaluated inside the march, from the previous step's velocity (lagged
    explicit splitting; ``drag_iterations=2`` adds a corrected pass at the
    new velocity).  With ``zero_loads=True`` it gives still-water
    free-decay damping (classical hyperbolic amplitude decay — the
    signature of quadratic damping, validated in tests/test_dynamics.py).

    ``ground_accel`` ([n_steps] ground acceleration [m/s^2] along
    ``ground_dir``) adds SEISMIC time-history excitation: the standard
    relative-coordinate formulation with effective force
    F_eff(t) = -M iota a_g(t), where iota is the consistent-mass rigid
    influence vector projected to the reduced basis (same construction as
    `ops.seismic`'s participation).  Returned displacements are RELATIVE
    to the ground.  Combine with ``zero_loads=True`` for a pure
    earthquake run, or with a wave for combined action.
    """
    from .morison import hydro_diameter_m, morison_phase_batch
    from .solve import factor_dense, solve_factored
    from .spectrum import SpectralSea, morison_sea_batch

    dtype = refined.coords.dtype
    case = case.cast(dtype)
    if topside_mass_t is None:
        topside_mass_t = float(case.custom_sw_tonnes)
    cb = _cb_reduce(coarse, refined, n_seg, float(case.E), float(case.nu),
                    topside_mass_t, n_chain_modes,
                    support_stiffness=support_stiffness,
                    added_mass_Ca=added_mass_Ca,
                    rho_water=float(case.rho_water))
    nc = cb.nc

    with jax.default_matmul_precision("highest"):
        K_ff = cb.K_red[jnp.ix_(cb.free, cb.free)]
        M_ff = cb.M_red[jnp.ix_(cb.free, cb.free)]
        omega_n, _ = _modal_from_ff(K_ff, M_ff, cb.free, cb.n_red, 6, dtype)
    omega_np = np.asarray(omega_n)
    w1 = float(omega_np[0])
    w2 = next((float(w) for w in omega_np[1:] if w > 1.01 * w1), 3.0 * w1)
    alpha = damping_ratio * 2.0 * w1 * w2 / (w1 + w2)
    beta_r = damping_ratio * 2.0 / (w1 + w2)

    with jax.default_matmul_precision("highest"):
        ts = jnp.arange(n_steps, dtype=dtype) * dt
        ramp_arr = jnp.ones((n_steps,), dtype)  # wave-load ramp (see below)
        if zero_loads:
            F_f = jnp.zeros((n_steps, cb.free.shape[0]), dtype)
        elif wave is None:
            raise ValueError("transient_response_condensed needs a wave or "
                             "SpectralSea unless zero_loads=True (free "
                             "vibration)")
        else:
            from .morison import hydro_members
            if case.slam_cs:
                raise ValueError("dynamics loading uses the separable "
                                 "phase/spectral matmul; slamming "
                                 "(slam_cs > 0) is pointwise-path only")
            # with the relative-velocity formulation the drag term is
            # state-dependent and evaluated inside the march; precompute
            # only the inertia (+ static) loads here by zeroing Cd
            Cd_pre = 0.0 if relative_drag else case.Cd
            conn_h, D_m, Cd_h, Cm_h = hydro_members(
                refined, case.marine_growth_mm, Cd_pre, case.Cm)
            if isinstance(wave, SpectralSea):
                mb = morison_sea_batch(wave, refined.coords, conn_h,
                                       D_m, case.wave_dir_deg,
                                       case.current_dir_deg, Cd_h,
                                       Cm_h, case.rho_water, ts,
                                       n_gauss=n_gauss,
                                       stretching=stretching)
                T_ramp = float(wave.Tp)
            else:
                mb = morison_phase_batch(wave, refined.coords, conn_h,
                                         D_m, case.wave_dir_deg,
                                         case.current_dir_deg, Cd_h,
                                         Cm_h, case.rho_water, ts,
                                         n_gauss=n_gauss,
                                         stretching=stretching)
                T_ramp = float(wave.T)
            F_red = _cb_reduced_loads(cb, refined, case, mb.nodal_forces,
                                      nc, n_seg, dtype)
            F_f = F_red[:, cb.free]
            if ramp_periods > 0:
                ramp_arr = jnp.minimum(ts / (ramp_periods * T_ramp), 1.0)
                F_f = F_f * ramp_arr[:, None]

        if ground_accel is not None:
            ag = jnp.asarray(ground_accel, dtype)
            if ag.shape[0] != n_steps:
                raise ValueError(f"ground_accel has {ag.shape[0]} samples "
                                 f"but n_steps = {n_steps}")
            gd = np.asarray(ground_dir, np.float64)
            gd = gd / np.linalg.norm(gd)
            # consistent-mass rigid influence vector on the reduced basis
            # (interface translations incl. the supports, zero generalized
            # coords — see ops.seismic's participation construction)
            iota = jnp.zeros((cb.n_red,), dtype)
            for c in range(3):
                iota = iota.at[c:6 * nc:6].set(jnp.asarray(gd[c], dtype))
            b = (cb.M_red @ iota)[cb.free]            # [nf], tonnes
            # F_eff = -M iota a_g; a in m/s^2 -> mm/s^2 so t*mm/s^2 = N
            F_f = F_f - b[None, :] * (ag * 1e3)[:, None]

        C_ff = alpha * M_ff + beta_r * K_ff
        bN, gN = newmark
        a0 = 1.0 / (bN * dt * dt)
        a1 = gN / (bN * dt)
        a2 = 1.0 / (bN * dt)
        a3 = 1.0 / (2.0 * bN) - 1.0
        a4 = gN / bN - 1.0
        a5 = dt / 2.0 * (gN / bN - 2.0)
        K_eff = K_ff + a0 * M_ff + a1 * C_ff
        nf = K_ff.shape[0]
        fac = factor_dense(K_eff, jnp.arange(nf))

        # relative-velocity drag: a per-step force from the CURRENT
        # structural velocity (hydrodynamic damping).  Evaluated with the
        # previous step's velocity (explicit/lagged, O(dt) splitting) and
        # optionally re-evaluated at the corrected velocity
        # (drag_iterations = 2) — the effective matrix stays constant so
        # the march remains one factorization + scan.
        if relative_drag:
            drag_wave = None if zero_loads else wave
            drag_at = _relative_drag_fn(refined, case, drag_wave, n_gauss,
                                        stretching, dtype)

            def drag_reduced(t, v_free):
                v_red = jnp.zeros((cb.n_red,), dtype).at[cb.free].set(v_free)
                v_nodal = _cb_expand(cb, v_red).reshape(-1, 6)[:, :3] / 1e3
                nodal = drag_at(t, v_nodal)                 # [n, 3] N
                F_full = jnp.zeros((refined.n_dof // 6, 6), dtype)
                F_full = F_full.at[:, :3].set(nodal).reshape(-1)
                return _cb_reduce_forces(cb, F_full, nc, n_seg,
                                         dtype)[cb.free]
        else:
            drag_reduced = None

        # initial state
        if u0 is not None:
            u = _cb_project(cb, jnp.asarray(u0, dtype))[cb.free]
        else:
            u = jnp.zeros((nf,), dtype)
        v = jnp.zeros((nf,), dtype)
        # consistent initial acceleration: M a0 = F0 - C v0 - K u0
        Mfac = factor_dense(M_ff, jnp.arange(nf))
        F0 = F_f[0]
        if relative_drag:
            # the same startup ramp the precomputed loads get (the drag
            # carries the wave-drag action, so an unramped drag would
            # reintroduce the startup transient the ramp suppresses)
            F0 = F0 + ramp_arr[0] * drag_reduced(ts[0], v)
        acc = solve_factored(Mfac, F0 - K_ff @ u - C_ff @ v)

        def step(carry, inp):
            u, v, acc = carry
            Fn1, t1, r1 = inp
            hist = M_ff @ (a0 * u + a2 * v + a3 * acc) \
                + C_ff @ (a1 * u + a4 * v + a5 * acc)
            if relative_drag:
                Fd = r1 * drag_reduced(t1, v)              # lagged velocity
                u1 = solve_factored(fac, Fn1 + Fd + hist)
                acc1 = a0 * (u1 - u) - a2 * v - a3 * acc
                v1 = v + dt * ((1.0 - gN) * acc + gN * acc1)
                for _ in range(max(int(drag_iterations) - 1, 0)):
                    Fd = r1 * drag_reduced(t1, v1)         # corrector pass
                    u1 = solve_factored(fac, Fn1 + Fd + hist)
                    acc1 = a0 * (u1 - u) - a2 * v - a3 * acc
                    v1 = v + dt * ((1.0 - gN) * acc + gN * acc1)
            else:
                u1 = solve_factored(fac, Fn1 + hist)
                acc1 = a0 * (u1 - u) - a2 * v - a3 * acc
                v1 = v + dt * ((1.0 - gN) * acc + gN * acc1)
            return (u1, v1, acc1), u1

        _, u_hist = jax.lax.scan(step, (u, v, acc),
                                 (F_f[1:], ts[1:], ramp_arr[1:]))
        u_hist = jnp.concatenate([u[None], u_hist], axis=0)  # [S, nf]

        U_red = jnp.zeros((n_steps, cb.n_red), dtype)
        U_red = U_red.at[:, cb.free].set(u_hist)
        U_time = _cb_expand(cb, U_red)                      # [S, n_dof_ref]

        from .beams import matmul12, matvec12
        from .sections import von_mises_8pt
        KT6 = -matmul12(cb.K_local, cb.T)[:, :6, :]
        dofs = jnp.concatenate([6 * refined.conn[:, 0:1] + jnp.arange(6),
                                6 * refined.conn[:, 1:2] + jnp.arange(6)],
                               axis=-1)
        F1 = matvec12(KT6, U_time[:, dofs])
        vm = von_mises_8pt(refined.sections, refined.sect_id,
                           F1[..., 0], F1[..., 1], F1[..., 2],
                           F1[..., 3], F1[..., 4], F1[..., 5])
        tip = jnp.max(jnp.linalg.norm(
            U_time.reshape(n_steps, -1, 6)[:, :, :3], axis=-1), axis=-1)
        return TransientResponse(
            ts=ts, U_time=U_time, utilization=vm / case.fy,
            tip_displacement_mm=tip,
            omega1=jnp.asarray(w1, dtype),
            rayleigh_alpha=jnp.asarray(alpha, dtype),
            rayleigh_beta=jnp.asarray(beta_r, dtype),
        )


def _cb_project(cb: CBReduction, U_full):
    """Project a full refined displacement vector [n_dof_ref] to CB
    coordinates [n_red]: interface DOFs copy over; generalized coordinates
    are the mass-orthonormal projection q = Phi^T M_ii (v - Psi u_b)."""
    nc = cb.nc
    u_b = U_full[: 6 * nc]
    v = U_full[6 * nc:].reshape(cb.Mc, -1, 6)
    # refine_model interior layout is member-major [Mc, n_int, 6] == chain
    v = v.reshape(cb.Mc, -1)                                # [Mc, N]
    ub_e = u_b[cb.bdof.reshape(-1)].reshape(cb.Mc, 12)
    resid = v - jnp.einsum("mnj,mj->mn", cb.Psi, ub_e)
    # M_ii is not stored in the reduction, so use the least-squares
    # projection onto span(Phi) via batched normal equations — exact when
    # resid lies in that span, and the best reduced-basis representation
    # otherwise (initial conditions built from static solutions of the
    # same chains are the usual case).
    G = jnp.einsum("mnq,mnr->mqr", cb.Phi, cb.Phi)          # [Mc, m, m]
    b = jnp.einsum("mnq,mn->mq", cb.Phi, resid)             # [Mc, m]
    q = jnp.linalg.solve(G, b[..., None])[..., 0]           # [Mc, m]
    out = jnp.zeros((cb.n_red,), U_full.dtype)
    out = out.at[: 6 * nc].set(u_b)
    out = out.at[6 * nc:].set(q.reshape(-1))
    return out


class HarmonicResponse(NamedTuple):
    """Steady-state wave-frequency dynamic response (one wave period)."""

    ts: jnp.ndarray               # [S] sample times
    U_time: jnp.ndarray           # [S, n_dof] dynamic displacements (mm/rad)
    U_static: jnp.ndarray         # [S, n_dof] quasi-static displacements
    utilization: jnp.ndarray      # [S, M] dynamic von Mises utilization
    utilization_static: jnp.ndarray
    daf: jnp.ndarray              # [] max dynamic / max static displacement
    omega: jnp.ndarray            # wave angular frequency
    rayleigh_alpha: jnp.ndarray
    rayleigh_beta: jnp.ndarray


def _chol_scaled(S):
    """Jacobi-scaled Cholesky: factor d S d with d = diag(S)^(-1/2).

    The symmetric scaling is what keeps beam-stiffness systems (entries
    spanning ~8 orders of magnitude between translational and rotational
    DOFs) Cholesky-positive in float32 — same recipe as
    ``solve.factor_dense``."""
    d = 1.0 / jnp.sqrt(jnp.diagonal(S))
    L = jnp.linalg.cholesky(S * d[:, None] * d[None, :])
    return L, d


def _cho_solve_scaled(L, d, B):
    """Solve S X = B through the scaled factor; B is [n] or [n, k]."""
    vec = B.ndim == 1
    y = d[:, None] * (B[:, None] if vec else B)
    y = jax.scipy.linalg.solve_triangular(L, y, lower=True)
    y = jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
    y = d[:, None] * y
    return y[:, 0] if vec else y


def harmonic_solve(K_ff, M_ff, F_hat_f, omega, alpha, beta):
    """Frequency-domain solves (K + i w C - w^2 M) U_j = F_j per harmonic.

    ``F_hat_f``: [n_h + 1, n_free] complex one-sided Fourier coefficients
    (index j <-> frequency j*omega; j = 0 is the mean).  Rayleigh damping
    C = alpha M + beta K.  Returns complex U_hat_f of the same shape.

    Real formulation (written for an accelerator without complex solves or
    real LU; kept until measured on the GPU): with A = K - w^2 M and
    B = w C (symmetric, B SPD for w > 0 and Rayleigh damping), the complex
    system realifies to  A x - B y = f,  B x + A y = g  (U = x + i y,
    F = f + i g), and eliminating x through B gives the Schur complement

        (B + A B^-1 A) y = (B^-1 A)^T g - f,   x = B^-1 g - (B^-1 A) y.

    B + A B^-1 A is SPD for EVERY w — including across resonances where
    A = K - w^2 M is indefinite — so the whole solve is two Jacobi-scaled
    Cholesky factorizations per harmonic, no LU, no complex kernels.
    Cross-checked against the complex LAPACK solve at rtol 1e-10 on CPU
    (tests/test_dynamics.py).
    """
    Ur, Ui = harmonic_solve_real(K_ff, M_ff,
                                 F_hat_f.real.astype(K_ff.dtype),
                                 F_hat_f.imag.astype(K_ff.dtype),
                                 omega, alpha, beta)
    cdtype = jnp.complex64 if K_ff.dtype == jnp.float32 else jnp.complex128
    return (Ur + 1j * Ui).astype(cdtype)


def harmonic_solve_real(K_ff, M_ff, F_re, F_im, omega, alpha, beta):
    """The real-pair core of :func:`harmonic_solve`: ``(U_re, U_im)`` each
    [n_h + 1, n_free].  This is the form the device paths consume directly:
    nothing complex is built on device (written for an accelerator that
    rejected complex arithmetic; kept until measured on the GPU)."""
    n_h = F_re.shape[0] - 1
    dtype = K_ff.dtype

    LK, dK = _chol_scaled(K_ff)
    U0 = _cho_solve_scaled(LK, dK, F_re[0])
    if n_h == 0:
        return U0[None], jnp.zeros_like(U0)[None]

    def solve_w(args):
        # the harmonic index enters only through the VALUE of w, so all
        # harmonics share ONE traced body (lax.map) — unrolling multiplies
        # the compile time for no runtime gain
        w, f, g = args
        A = K_ff - w**2 * M_ff
        B = w * (alpha * M_ff + beta * K_ff)
        LB, dB = _chol_scaled(B)
        Z = _cho_solve_scaled(LB, dB, A)                 # B^-1 A
        S = B + A @ Z
        LS, dS = _chol_scaled(S)
        y = _cho_solve_scaled(LS, dS, Z.T @ g - f)
        x = _cho_solve_scaled(LB, dB, g) - Z @ y
        return x, y

    ws = jnp.arange(1, n_h + 1, dtype=dtype) * omega
    X, Y = jax.lax.map(solve_w, (ws, F_re[1:], F_im[1:]))
    return (jnp.concatenate([U0[None], X]),
            jnp.concatenate([jnp.zeros_like(U0)[None], Y]))


def real_dft_coeffs(F_t, n_h: int):
    """One-sided Fourier coefficients of a real [S, n] time history as a
    REAL pair ``(c_re [n_h+1, n], c_im)``, matching
    ``rfft(F, axis=0) / S`` with bins 1..n_h doubled (and an even-length
    Nyquist bin halved back) — as two [n_h+1, S] matmuls (written for an
    accelerator without FFT or complex dtypes; kept until measured on the
    GPU)."""
    S = F_t.shape[0]
    dtype = F_t.dtype
    j = jnp.arange(n_h + 1, dtype=dtype)[:, None]
    s = jnp.arange(S, dtype=dtype)[None, :]
    ang = 2.0 * jnp.pi * j * s / S
    scale = jnp.full((n_h + 1, 1), 2.0 / S, dtype)
    scale = scale.at[0].set(1.0 / S)
    if S % 2 == 0 and n_h == S // 2:
        scale = scale.at[-1].set(1.0 / S)
    c_re = (jnp.cos(ang) * scale) @ F_t
    c_im = (-jnp.sin(ang) * scale) @ F_t
    return c_re, c_im


def real_harmonic_reconstruct(U_re, U_im, omega, ts):
    """Time reconstruction u(t) = Re sum_j (U_j e^{+i j w t}) from the real
    coefficient pair: cos/sin matmuls only (no complex on device)."""
    dtype = U_re.dtype
    j = jnp.arange(U_re.shape[0], dtype=dtype)
    ang = j[None, :] * omega * ts[:, None]               # [S, n_h+1]
    return jnp.cos(ang) @ U_re - jnp.sin(ang) @ U_im


def dynamic_response(model, wave, case, n_harmonics: int = 6,
                     damping_ratio: float = 0.02, n_steps: int = 72,
                     n_gauss: int = 15,
                     topside_mass_t: float | None = None,
                     support_stiffness=None,
                     added_mass_Ca=None) -> HarmonicResponse:
    """Steady-state dynamic response to the (nonlinear) Morison wave loading.

    Beyond the reference's quasi-static-only scope: the load time history
    over one wave period — including the drag nonlinearity, which spreads
    energy into super-harmonics — is Fourier-decomposed and each harmonic
    solved through (K + i w C - w^2 M) with Rayleigh damping calibrated to
    ``damping_ratio`` at the first two natural frequencies.  The quasi-static
    response to the same loads comes from the j-independent K solve, so the
    dynamic amplification factor (DAF) is a direct output.

    ``topside_mass_t`` defaults to the case's custom self-weight tonnage
    (the deck mass that dominates jacket dynamics).
    """
    from ..api import assemble_loads
    from ..ops.morison import morison_phase_batch
    from .sections import von_mises_8pt

    dtype = model.coords.dtype
    case = case.cast(dtype)
    E = case.E
    if topside_mass_t is None:
        topside_mass_t = float(case.custom_sw_tonnes)

    with jax.default_matmul_precision("highest"):
        K, M, free, (K_local, T, L_m) = _build_km(
            model, float(E), float(case.nu), topside_mass_t,
            added_mass_Ca, float(case.rho_water))
        if support_stiffness is not None:
            from .solve import ground_with_springs
            K, free = ground_with_springs(K, model.fixed_mask,
                                          support_stiffness, dtype)
        K_ff = K[jnp.ix_(free, free)]
        M_ff = M[jnp.ix_(free, free)]

        # Rayleigh damping calibrated at the first two distinct natural
        # frequencies (reusing the already-assembled matrices)
        omega_n, _ = _modal_from_ff(K_ff, M_ff, free, model.n_dof, 6, dtype)
    omega_np = np.asarray(omega_n)
    w1 = float(omega_np[0])
    # first frequency distinct from w1 (symmetric jackets carry a degenerate
    # sway pair; an asymmetric model's second mode is already distinct)
    w2 = next((float(w) for w in omega_np[1:] if w > 1.01 * w1), 3.0 * w1)
    alpha = damping_ratio * 2.0 * w1 * w2 / (w1 + w2)
    beta = damping_ratio * 2.0 / (w1 + w2)

    if case.slam_cs:
        raise ValueError("dynamics loading uses the separable phase "
                         "matmul; slamming (slam_cs > 0) is pointwise-"
                         "path only")
    from .morison import hydro_members
    conn_h, D_m, Cd_h, Cm_h = hydro_members(
        model, case.marine_growth_mm, case.Cd, case.Cm)
    # everything after the damping calibration is ONE jitted program, so
    # the pipeline is a single dispatch instead of one per operation
    return _dynamic_core_dense(model, wave, case, K_ff, M_ff, K_local, T,
                               L_m, free, conn_h, D_m, Cd_h, Cm_h,
                               alpha, beta,
                               n_h=min(n_harmonics, n_steps // 2),
                               n_steps=n_steps, n_gauss=n_gauss)


@partial(jax.jit, static_argnames=("n_h", "n_steps", "n_gauss"))
def _dynamic_core_dense(model, wave, case, K_ff, M_ff, K_local, T, L_m,
                        free, conn_h, D_m, Cd_h, Cm_h, alpha, beta,
                        n_h: int, n_steps: int, n_gauss: int):
    """The post-calibration half of :func:`dynamic_response`, compiled."""
    from ..api import assemble_loads
    from ..ops.morison import morison_phase_batch
    from .sections import von_mises_8pt

    dtype = model.coords.dtype
    with jax.default_matmul_precision("highest"):
        # loads over one period (separable fast path)
        ts = jnp.arange(n_steps, dtype=dtype) * wave.T / n_steps
        mb = morison_phase_batch(wave, model.coords, conn_h, D_m,
                                 case.wave_dir_deg, case.current_dir_deg,
                                 Cd_h, Cm_h, case.rho_water, ts,
                                 n_gauss=n_gauss)
        F = jax.vmap(lambda nodal: assemble_loads(model, case, nodal,
                                                  L_m))(mb.nodal_forces)
        F_f = F[:, free]                                     # [S, n_free]

        # one-sided Fourier coefficients as a REAL pair (see
        # real_dft_coeffs),
        # expanding F(t) = Re[sum_j c_j e^{+i j w t}] — the +i convention
        # the damped operator (K + i w C - w^2 M) uses.
        c_re, c_im = real_dft_coeffs(F_f, n_h)              # [n_h+1, n_free]

        omega = wave.omega.astype(dtype)
        U_re, U_im = harmonic_solve_real(K_ff, M_ff, c_re, c_im, omega,
                                         alpha, beta)
        # quasi-static comparison: one Cholesky factor, all 2(n_h+1) RHS
        LKs, dKs = _chol_scaled(K_ff)
        Us_re = _cho_solve_scaled(LKs, dKs, c_re.T).T
        Us_im = _cho_solve_scaled(LKs, dKs, c_im.T).T

        def reconstruct(U_r, U_i):
            u = real_harmonic_reconstruct(U_r, U_i, omega, ts)
            U_full = jnp.zeros((n_steps, model.n_dof), dtype=dtype)
            return U_full.at[:, free].set(u.astype(dtype))

        U_time = reconstruct(U_re, U_im)
        U_static = reconstruct(Us_re, Us_im)

        dofs = jnp.concatenate([6 * model.conn[:, 0:1] + jnp.arange(6),
                                6 * model.conn[:, 1:2] + jnp.arange(6)], axis=-1)

        def util_of(U):
            u_loc = jnp.einsum("mij,smj->smi", T, U[:, dofs])
            F_loc = jnp.einsum("mij,smj->smi", K_local, u_loc)
            F1 = -F_loc[:, :, :6]
            vm = von_mises_8pt(model.sections, model.sect_id,
                               F1[..., 0], F1[..., 1], F1[..., 2],
                               F1[..., 3], F1[..., 4], F1[..., 5])
            return vm / case.fy

        disp = lambda U: jnp.max(jnp.linalg.norm(
            U.reshape(n_steps, -1, 6)[:, :, :3], axis=-1))
        return HarmonicResponse(
            ts=ts, U_time=U_time, U_static=U_static,
            utilization=util_of(U_time), utilization_static=util_of(U_static),
            daf=disp(U_time) / jnp.maximum(disp(U_static), 1e-30),
            omega=omega,
            rayleigh_alpha=jnp.asarray(alpha, dtype),
            rayleigh_beta=jnp.asarray(beta, dtype),
        )


def mac(shapes_a, shapes_b) -> jnp.ndarray:
    """Modal Assurance Criterion matrix between two mode-shape sets.

    MAC_ij = (phi_a_i . phi_b_j)^2 / (|phi_a_i|^2 |phi_b_j|^2) in [0, 1] —
    the standard mode-pairing/correlation diagnostic (1 = same shape up to
    scale, ~0 = orthogonal).  ``shapes_*``: [n_modes, n_dof] on the SAME
    DOF layout (e.g. dense vs Craig-Bampton-expanded modes of one refined
    mesh, or as-designed vs as-damaged modes for model updating).
    """
    A = jnp.asarray(shapes_a)
    B = jnp.asarray(shapes_b)
    num = (A @ B.T) ** 2
    den = jnp.sum(A * A, axis=1)[:, None] * jnp.sum(B * B, axis=1)[None, :]
    return num / jnp.maximum(den, 1e-300)
