"""Buckling checks: member Euler screening and global linearized buckling.

A capability beyond the reference, which excludes buckling entirely (its
Info tab exclusion list, `JacketAnalysisGUI_v2.py:1544-1799`)
— yet axially loaded tubular members are exactly where jacket designs fail
first.  Two levels, both batched:

1. :func:`euler_member_screen` — per-member axial force vs the Euler
   critical load pi^2 E I / (K L)^2 (a code-style slenderness screen;
   effective-length factor selectable).
2. :func:`buckling_analysis` — linearized (eigenvalue) buckling: the
   consistent geometric stiffness K_G(N) is assembled from the linear
   solution's member axial forces and the critical load factor comes from
   K phi = -lambda K_G phi, solved as a symmetric eigenproblem through the
   Cholesky factor of K_ff.  lambda_cr > 1 means the applied load case is
   below the elastic buckling load.

Geometric element stiffness: the standard consistent 12x12 beam matrix
(lateral 6/5, coupling L/10, rotary 2L^2/15 / -L^2/30 terms in both bending
planes, with the same theta_y sign pattern as the elastic matrix), expressed
as one [M, 4] x [4, 144] pattern contraction like ops/beams.py.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .beams import congruence, local_axes, transformation_matrices


def _build_gpat():
    """Constant patterns: K_g_local = (N/L) P0 + N P1 + N L P2 + N L P3."""
    P = np.zeros((4, 12, 12))

    def sym(c, i, j, v):
        P[c, i, j] += v
        if i != j:
            P[c, j, i] += v

    # lateral terms 6/5 (both planes): v = dofs 1/7, w = dofs 2/8
    for a, b in [(1, 7), (2, 8)]:
        sym(0, a, a, 1.2)
        sym(0, b, b, 1.2)
        sym(0, a, b, -1.2)
    # coupling N/10: v-theta_z (1,5 | 7,11) plane, sign like elastic K
    sym(1, 1, 5, 0.1)
    sym(1, 1, 11, 0.1)
    sym(1, 7, 5, -0.1)
    sym(1, 7, 11, -0.1)
    # w-theta_y (2,4 | 8,10) plane: theta_y = -w' sign pattern
    sym(1, 2, 4, -0.1)
    sym(1, 2, 10, -0.1)
    sym(1, 8, 4, 0.1)
    sym(1, 8, 10, 0.1)
    # rotary 2 L^2 / 15 on theta^2 diagonals
    for a, b in [(5, 11), (4, 10)]:
        sym(2, a, a, 2.0 / 15.0)
        sym(2, b, b, 2.0 / 15.0)
        sym(3, a, b, -1.0 / 30.0)
    return P.reshape(4, 144)


_GPAT = _build_gpat()


def element_geometric_stiffness(coords, conn, N_axial, W=None):
    """Stacked global-frame geometric stiffness [M, 12, 12].

    ``N_axial``: [M] member axial force in N, POSITIVE IN COMPRESSION (so
    the assembled K_G is the destabilizing matrix and the eigenproblem reads
    K phi = lambda K_G phi).  Units: N/mm blocks like the elastic K.
    ``W`` ([M, 12, 12], from :func:`ops.beams.release_W`): consistent
    projection for members with pinned end releases — the geometric
    stiffness must live on the same kept-DOF subspace as the released
    elastic K, else the zeroed elastic rotation rows against nonzero K_G
    rows produce spurious near-zero buckling factors.
    """
    c1 = coords[conn[:, 0]]
    c2 = coords[conn[:, 1]]
    dL = c2 - c1
    L = jnp.linalg.norm(dL, axis=-1)
    L_mm = L * 1000.0
    coeffs = jnp.stack([
        N_axial / L_mm,
        N_axial,
        N_axial * L_mm,
        N_axial * L_mm,
    ], axis=-1)                                            # [M, 4]
    pat = jnp.asarray(_GPAT, dtype=coords.dtype)
    Kg_local = (coeffs @ pat).reshape(-1, 12, 12)
    if W is not None:
        Kg_local = congruence(W, Kg_local)
    R = local_axes(dL, L)
    T = transformation_matrices(R)
    return congruence(T, Kg_local)


class BucklingResults(NamedTuple):
    load_factor: jnp.ndarray        # [n_modes] lambda_cr (ascending, >0)
    mode_shapes: jnp.ndarray        # [n_modes, n_dof]
    member_axial_N: jnp.ndarray     # [M] axial force used (+ compression)


class EulerScreen(NamedTuple):
    axial_N: jnp.ndarray            # [M] axial force (+ compression)
    P_euler_N: jnp.ndarray          # [M] pi^2 E I / (K L)^2
    utilization: jnp.ndarray        # [M] axial / P_euler (0 for tension)


def member_axial_forces(results) -> jnp.ndarray:
    """[M] axial force, positive in compression, from an AnalysisResults.

    F1_local carries the node-1 end force with the reference's sign flip
    (`JacketAnalysisGUI_v2.py:424-432`), under which a member in pure
    compression has F1_x = -P (verified against an axially loaded column),
    hence the negation here.
    """
    return -results.F1_local[..., 0]


def euler_member_screen(model, results, E: float = 210000.0,
                        k_factor: float = 1.0,
                        n_seg: int = 1) -> EulerScreen:
    """Member-level Euler buckling screen (pin-ended by default).

    ``k_factor``: effective-length factor (1.0 pinned-pinned; 0.7/2.0 etc.
    per support conditions — jacket braces are commonly checked with 0.8).

    IMPORTANT for refined meshes: Euler capacity depends on the PHYSICAL
    member length.  When ``model``/``results`` live on a
    ``refine_model(coarse, n_seg)`` mesh, pass that ``n_seg`` — the screen
    then aggregates each parent member's chain (full length, worst-segment
    axial force).  Screening refined elements with their segment lengths
    would inflate P_euler by n_seg^2 and hide every real failure.
    Outputs have one row per PHYSICAL member (M_refined / n_seg rows).
    """
    _, _, _, L = model.member_geometry()
    N = member_axial_forces(results)
    sect_id = model.sect_id
    if n_seg > 1:
        Mc = model.n_members // n_seg
        # chain segments are member-major and colinear: the physical length
        # is the sum; the governing axial force is the chain max
        L = jnp.sum(L.reshape(Mc, n_seg), axis=1)
        N = jnp.max(N.reshape(Mc, n_seg), axis=1)
        sect_id = sect_id.reshape(Mc, n_seg)[:, 0]
    L_mm = L * 1000.0
    Imin = jnp.minimum(model.sections.Iy, model.sections.Iz)[sect_id]
    P_cr = jnp.pi**2 * E * Imin / (k_factor * L_mm) ** 2
    util = jnp.where(N > 0, N / P_cr, 0.0)
    return EulerScreen(axial_N=N, P_euler_N=P_cr, utilization=util)


def buckling_analysis(model, results, E: float = 210000.0, nu: float = 0.3,
                      n_modes: int = 4,
                      support_stiffness=None) -> BucklingResults:
    """Linearized global buckling factors for the applied load case.

    Solves K phi = lambda K_G(N) phi on the free DOFs (dense path; use the
    coarse model or mild refinements).  ``results`` supplies the member
    axial forces of the linear solution; lambda_cr is the multiplier on the
    WHOLE load case at which elastic bifurcation occurs.

    ``support_stiffness`` puts the supports on 6-DOF foundation springs
    (see ``api.analyze_ssi``): the eigenproblem runs over ALL DOFs with
    ``K + diag(k)`` — foundation flexibility lowers the buckling factors.
    """
    from .assembly import assemble_dense
    from .beams import element_stiffness
    from .solve import free_fixed_dofs

    dtype = model.coords.dtype
    G = E / (2.0 * (1.0 + nu))
    with jax.default_matmul_precision("highest"):
        Kg, _, _, _ = element_stiffness(model.coords, model.conn,
                                        model.sections, model.sect_id, E, G,
                                        release=model.release)
        N = member_axial_forces(results).astype(dtype)
        W_rel = None
        if model.release is not None:
            from .beams import release_W
            W_rel = release_W(model.coords, model.conn, model.sections,
                              model.sect_id, E, G, model.release)
        KGg = element_geometric_stiffness(model.coords, model.conn, N,
                                          W=W_rel)
        K = assemble_dense(Kg, model.conn, model.n_dof)
        KG = assemble_dense(KGg, model.conn, model.n_dof)
        if support_stiffness is not None:
            from .solve import ground_with_springs
            K, free = ground_with_springs(K, model.fixed_mask,
                                          support_stiffness, dtype)
        else:
            free, _ = free_fixed_dofs(model.fixed_mask)
            free = jnp.asarray(free)
        K_ff = K[jnp.ix_(free, free)]
        KG_ff = KG[jnp.ix_(free, free)]

        # K phi = lambda K_G phi -> L^-1 K_G L^-T y = (1/lambda) y with
        # K_ff = L L^T; the LARGEST eigenvalues mu give the LOWEST factors
        lam, phi_f = _buckling_pencil(K_ff, KG_ff, n_modes, dtype)
        shapes = jnp.zeros((n_modes, model.n_dof), dtype)
        shapes = shapes.at[:, free].set(phi_f.T)
    return BucklingResults(load_factor=lam, mode_shapes=shapes,
                           member_axial_N=N)


def _buckling_pencil(K_ff, KG_ff, n_modes, dtype):
    """Lowest buckling factors of K phi = lambda K_G phi (shared by the
    dense and Craig-Bampton reduced paths): Jacobi-scaled Cholesky of K,
    largest eigenvalues of L^-1 K_G L^-T."""
    d = 1.0 / jnp.sqrt(jnp.diagonal(K_ff))
    Ks = K_ff * d[:, None] * d[None, :]
    Lc = jnp.linalg.cholesky(Ks)
    B = KG_ff * d[:, None] * d[None, :]
    Y = jax.scipy.linalg.solve_triangular(Lc, B, lower=True)
    A = jax.scipy.linalg.solve_triangular(Lc, Y.T, lower=True)
    A = 0.5 * (A + A.T)
    from .dynamics import _eigh_backend
    if _eigh_backend() == "subspace":
        # block power iteration (written for an accelerator without eigh;
        # kept until measured on the GPU): the governing factors are
        # 1 / (largest mu), exactly what it converges to first
        # (ops/eigen.py)
        from .eigen import subspace_largest
        mu_top, phi_y = subspace_largest(A, n_modes)
    else:
        mu, V = jnp.linalg.eigh(A)
        mu_top = mu[::-1][:n_modes]
        phi_y = V[:, ::-1][:, :n_modes]
    lam = jnp.where(mu_top > 1e-12, 1.0 / mu_top, jnp.inf)
    phi_f = d[:, None] * jax.scipy.linalg.solve_triangular(
        Lc.T, phi_y, lower=False)
    return lam, phi_f


def buckling_analysis_condensed(coarse, refined, n_seg: int, results,
                                E: float = 210000.0, nu: float = 0.3,
                                n_modes: int = 4, n_chain_modes: int = 12,
                                support_stiffness=None) -> BucklingResults:
    """Global buckling of a chain-refined mesh on the Craig-Bampton basis.

    The dense path's O(n^3) eigensolve caps at a few thousand DOF; here
    the geometric stiffness (from ``results`` — a condensed analysis of
    the REFINED mesh, e.g. :func:`api.analyze_condensed`, so the axial
    state lives on every refined element) is projected through the same
    reduction as the mass matrix in
    :func:`ops.dynamics.modal_analysis_condensed`:

        KG_bb_r = KG_bb + KG_ib^T Psi + Psi^T KG_ib + Psi^T KG_ii Psi
        KG_bq   = (KG_ib^T + Psi^T KG_ii) Phi,   KG_qq = Phi^T KG_ii Phi

    With ALL interior modes retained the basis is complete and the factors
    equal the dense refined solution exactly (tested); truncated
    fixed-interface modes approximate member-level buckling shapes the
    usual component-mode-synthesis way — keep ``n_chain_modes`` at or
    above the number of wavelengths you expect in the governing mode.
    Mode shapes are expanded to the full refined mesh.
    """
    from .dynamics import _cb_expand, _cb_reduce, _chain_blocks, _chain_dense

    dtype = refined.coords.dtype
    N = member_axial_forces(results).astype(dtype)
    if N.shape[0] != refined.n_members:
        raise ValueError(
            f"results carry {N.shape[0]} member forces but the refined "
            f"mesh has {refined.n_members} elements — pass a condensed "
            "analysis OF THE REFINED MESH (api.analyze_condensed)")
    with jax.default_matmul_precision("highest"):
        W = None
        if refined.release is not None:
            from .beams import release_W
            G = E / (2.0 * (1.0 + nu))
            W = release_W(refined.coords, refined.conn, refined.sections,
                          refined.sect_id, E, G, refined.release)
        KGg = element_geometric_stiffness(refined.coords, refined.conn, N,
                                          W=W)
        cb = _cb_reduce(coarse, refined, n_seg, E, nu, 0.0, n_chain_modes,
                        support_stiffness=support_stiffness)
        XA, XB, XC, XE = _chain_blocks(KGg, n_seg)
        X_ii, X_ib, X_bb = _chain_dense(XA, XB, XC, XE, n_seg)
        PsiT = jnp.swapaxes(cb.Psi, -1, -2)
        PhiT = jnp.swapaxes(cb.Phi, -1, -2)
        X_bb_r = X_bb + jnp.swapaxes(X_ib, -1, -2) @ cb.Psi \
            + PsiT @ X_ib + PsiT @ (X_ii @ cb.Psi)
        X_bq = (jnp.swapaxes(X_ib, -1, -2) + PsiT @ X_ii) @ cb.Phi
        X_qq = PhiT @ (X_ii @ cb.Phi)

        from .assembly import assemble_dense
        nc, Mc, m = cb.nc, cb.Mc, cb.m
        KG_red = jnp.zeros((cb.n_red, cb.n_red), dtype)
        KG_red = KG_red.at[:6 * nc, :6 * nc].set(
            assemble_dense(X_bb_r, coarse.conn, 6 * nc))
        KG_red = KG_red.at[cb.bdof[:, :, None], cb.qdof[:, None, :]].add(
            X_bq)
        KG_red = KG_red.at[cb.qdof[:, :, None], cb.bdof[:, None, :]].add(
            jnp.swapaxes(X_bq, -1, -2))
        KG_red = KG_red.at[cb.qdof[:, :, None], cb.qdof[:, None, :]].add(
            X_qq)

        K_ff = cb.K_red[jnp.ix_(cb.free, cb.free)]
        KG_ff = KG_red[jnp.ix_(cb.free, cb.free)]
        lam, phi_f = _buckling_pencil(K_ff, KG_ff, n_modes, dtype)
        shapes_r = jnp.zeros((n_modes, cb.n_red), dtype)
        shapes_r = shapes_r.at[:, cb.free].set(phi_f.T)
        shapes = _cb_expand(cb, shapes_r)
    return BucklingResults(load_factor=lam, mode_shapes=shapes,
                           member_axial_N=N)
