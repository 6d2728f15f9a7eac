"""Exact substructure condensation for refined jacket models.

This is the large-mesh *direct* solver.  ``refine_model(m, n_seg)``
subdivides every member into a chain of ``n_seg`` beam elements whose
interior nodes couple only along the chain.  Eliminating those interior DOFs
exactly (block-tridiagonal Gaussian elimination, i.e. the block Thomas
algorithm) reduces the refined system to a superelement problem on the
ORIGINAL interface nodes — for the default jacket, 126 DOF regardless of
refinement level.  The elimination is:

- *batched* over members (a ``vmap``'d ``lax.scan`` over the chain — 51
  members march their 31 interior nodes in lockstep);
- *multi-RHS*: all wave phases of a scan are condensed/back-substituted as
  one tensor, so a 360-phase scan costs one sweep;
- *exact* (a direct method): no iteration count, no preconditioner, and the
  refinement-induced ill-conditioning that breaks float32 dense Cholesky at
  10k+ DOF never materializes because each chain is eliminated locally.

This replaces the role the reference's dense LAPACK solve plays
(`/root/reference/JacketAnalysisGUI_v2.py:481-490`) at mesh sizes the
reference cannot reach (its assembly is O(n^2) memory,
`JacketAnalysisGUI_v2.py:444`); the interface problem is solved by the
same partitioned dense Cholesky as the small-model path, so results match
the generic solvers to solver precision (see tests/test_condense.py).

Chain block structure for one member (n = n_seg elements, chain nodes
0..n where 0, n are interface nodes):

    element p (0-based) has 12x12 K split into A_p B_p / C_p E_p
    interior diagonal    D_p     = E_{p-1} + A_p          (p = 1..n-1)
    interior off-diag    T[p,p+1] = B_p,  T[p+1,p] = C_p
    interface coupling   row 1 <- C_0 u_I,  row n-1 <- B_{n-1} u_J

Schur complement onto (u_I, u_J):

    K_super = [[A_0, 0], [0, E_{n-1}]]
              - [[B_0 Z0_1,      B_0 Zn_1],
                 [C_{n-1} Z0_{n-1}, C_{n-1} Zn_{n-1}]]
    with Z0 = T^{-1} [C_0; 0; ...],  Zn = T^{-1} [...; 0; B_{n-1}]

and condensed loads f_super = (f_I - B_0 (T^{-1} g)_1,
                               f_J - C_{n-1} (T^{-1} g)_{n-1}).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def _chol6(A):
    """Lower Cholesky of SPD [..., 6, 6] blocks, fully unrolled.

    ``jnp.linalg.cholesky`` + ``solve_triangular`` on 6x6 blocks lower to
    nested XLA loops whose per-step latency dominates the chain scans.
    Six static rank-1 updates, batched over the leading dims, keep
    everything elementwise.
    """
    cols = []
    for k in range(6):
        d = jnp.sqrt(A[..., k, k])
        col = A[..., k] / d[..., None]
        col = col * jnp.asarray((np.arange(6) >= k), A.dtype)
        cols.append(col)
        A = A - col[..., :, None] * col[..., None, :]
    return jnp.stack(cols, axis=-1)


def _fwd6(L, B):
    """Solve L Y = B (L lower [..., 6, 6], B [..., 6, r]), unrolled."""
    ys = []
    for i in range(6):
        acc = B[..., i, :]
        for j in range(i):
            acc = acc - L[..., i, j, None] * ys[j]
        ys.append(acc / L[..., i, i, None])
    return jnp.stack(ys, axis=-2)


def _bwd6(L, B):
    """Solve L^T X = B, unrolled."""
    ys = [None] * 6
    for i in reversed(range(6)):
        acc = B[..., i, :]
        for j in range(i + 1, 6):
            acc = acc - L[..., j, i, None] * ys[j]
        ys[i] = acc / L[..., i, i, None]
    return jnp.stack(ys, axis=-2)


class ChainFactor(NamedTuple):
    """Factorized interior chains + superelement matrices.

    Mc = number of original (coarse) members, n_int = n_seg - 1 interior
    nodes per chain.
    """

    K_super: jnp.ndarray    # [Mc, 12, 12] condensed superelement stiffness
    Cprime: jnp.ndarray     # [n_int, Mc, 6, 6] Thomas upper factors
    DinvL: jnp.ndarray      # [n_int, Mc, 6, 6] denom^{-1} L_p (for rhs sweep)
    Dinv: jnp.ndarray       # [n_int, Mc, 6, 6] denom^{-1}
    Z0: jnp.ndarray         # [n_int, Mc, 6, 6] T^{-1} L0 columns
    Zn: jnp.ndarray         # [n_int, Mc, 6, 6] T^{-1} Ln columns
    B0: jnp.ndarray         # [Mc, 6, 6] element-0 coupling (K_01)
    Cn: jnp.ndarray         # [Mc, 6, 6] element-(n-1) coupling (K_10)


def factor_chains(K_elems: jnp.ndarray, n_seg: int) -> ChainFactor:
    """Factor all member chains at once.

    ``K_elems``: [Mc * n_seg, 12, 12] refined-element global-frame stiffness
    matrices in the member-major order produced by ``refine_model``.
    """
    Mc = K_elems.shape[0] // n_seg
    Ke = K_elems.reshape(Mc, n_seg, 12, 12)
    A = Ke[:, :, 0:6, 0:6]
    B = Ke[:, :, 0:6, 6:12]
    C = Ke[:, :, 6:12, 0:6]
    E = Ke[:, :, 6:12, 6:12]

    n_int = n_seg - 1
    # interior diagonal blocks D_p = E_{p-1} + A_p, p = 1..n_int
    D = E[:, :-1] + A[:, 1:]                     # [Mc, n_int, 6, 6]
    U = B[:, 1:]                                 # T[p, p+1], p = 1..n_int-1 used
    L = C[:, 1:]                                 # T[p+1, p]

    # scan over the chain: forward block-Thomas on [L0 | Ln] columns
    D_t = jnp.moveaxis(D, 1, 0)                  # [n_int, Mc, 6, 6]
    U_t = jnp.moveaxis(U, 1, 0)
    L_t = jnp.moveaxis(L, 1, 0)

    eye = jnp.broadcast_to(jnp.eye(6, dtype=K_elems.dtype), (Mc, 6, 6))
    zeros = jnp.zeros_like(eye)
    L0_first = C[:, 0]                           # couples row 1 to u_I
    Ln_last = B[:, -1]                           # couples row n_int to u_J

    def fwd(carry, inp):
        cprime_prev, z0_prev, zn_prev, p = carry
        Dp, Up, Lprev = inp
        # Lprev = T[p, p-1] = C_{p-1} for p >= 2; row 1 has no left neighbor
        first = p == 0
        Lp = jnp.where(first, 0.0, 1.0) * Lprev
        denom = Dp - jnp.einsum("mij,mjk->mik", Lp, cprime_prev)
        # one batched Cholesky + one stacked 24-column triangular solve pair
        # per chain level: [Up | rhs0 | rhsn | Lp | I] solved together.
        # (denom is SPD: a Schur complement of the clamped chain stiffness.)
        rhs0 = jnp.where(first, 1.0, 0.0) * L0_first \
            - jnp.einsum("mij,mjk->mik", Lp, z0_prev)
        rhsn = -jnp.einsum("mij,mjk->mik", Lp, zn_prev)
        eyeb = jnp.broadcast_to(jnp.eye(6, dtype=Dp.dtype), Dp.shape)
        rhs = jnp.concatenate([Up, rhs0, rhsn, Lp, eyeb], axis=-1)
        # symmetric Jacobi scaling keeps the f32 Cholesky positive-definite:
        # rotational vs translational DOFs differ by ~L^2 in magnitude and
        # the unscaled Schur blocks lose definiteness to f32 rounding.
        dd = 1.0 / jnp.sqrt(jnp.abs(jnp.diagonal(denom, axis1=-2, axis2=-1)))
        denom_s = denom * dd[..., :, None] * dd[..., None, :]
        Ld = _chol6(denom_s)
        x = dd[..., :, None] * _bwd6(Ld, _fwd6(Ld, dd[..., :, None] * rhs))
        cprime, z0, zn, DinvLp, denom_inv = jnp.split(x, 5, axis=-1)
        return (cprime, z0, zn, p + 1), (cprime, DinvLp, denom_inv, z0, zn)

    # interior row p couples right via T[p, p+1] = B_p (p = 1..n_int-1): the
    # LAST interior row's B_{n-1} couples to the interface u_J, not the
    # chain, so zero it here (it enters through Ln_last instead); row p
    # couples left via T[p, p-1] = C_{p-1} (p = 2..n_int), zero for row 1.
    U_pad = jnp.concatenate([U_t[:-1], jnp.zeros_like(U_t[:1])], axis=0)
    L_pad = jnp.concatenate([jnp.zeros_like(L_t[:1]), L_t[:-1]], axis=0)
    (_, _, _, _), (Cp, DinvL, Dinv, Z0f, Znf) = jax.lax.scan(
        fwd, (zeros, zeros, zeros, 0), (D_t, U_pad, L_pad))

    # forward sweep gives y = (lower)^(-1)-ish; finish with backward sweep
    # to get the true Z0 = T^{-1} L0 and Zn = T^{-1} Ln columns, plus the
    # Ln injection into the last row (it enters the RHS of row n_int):
    # handle Ln by adding denom^{-1} Ln at the last forward step, which is
    # equivalent to an extra RHS column that is zero until p = n_int.
    lastDinv = Dinv[-1]
    Znf = Znf.at[-1].add(jnp.einsum("mij,mjk->mik", lastDinv, Ln_last))

    def bwd(carry, inp):
        v0_next, vn_next = carry
        cprime, y0, yn = inp
        v0 = y0 - jnp.einsum("mij,mjk->mik", cprime, v0_next)
        vn = yn - jnp.einsum("mij,mjk->mik", cprime, vn_next)
        return (v0, vn), (v0, vn)

    (_, _), (Z0b, Znb) = jax.lax.scan(
        bwd, (zeros, zeros), (Cp, Z0f, Znf), reverse=True)

    B0 = B[:, 0]
    Cn = C[:, -1]
    K00 = A[:, 0] - jnp.einsum("mij,mjk->mik", B0, Z0b[0])
    K01 = -jnp.einsum("mij,mjk->mik", B0, Znb[0])
    K10 = -jnp.einsum("mij,mjk->mik", Cn, Z0b[-1])
    K11 = E[:, -1] - jnp.einsum("mij,mjk->mik", Cn, Znb[-1])
    K_super = jnp.concatenate([
        jnp.concatenate([K00, K01], axis=-1),
        jnp.concatenate([K10, K11], axis=-1),
    ], axis=-2)

    return ChainFactor(K_super=K_super, Cprime=Cp, DinvL=DinvL, Dinv=Dinv,
                       Z0=Z0b, Zn=Znb, B0=B0, Cn=Cn)


def condense_loads(fac: ChainFactor, g):
    """Condense interior loads onto the interfaces.

    ``g``: [..., n_int, Mc, 6] interior nodal loads (leading batch axes OK,
    e.g. wave phases).  Returns (f_I_extra, f_J_extra, y) where the extras
    are [..., Mc, 6] to ADD to the interface nodes' loads and ``y`` is the
    forward-swept interior RHS (needed for back-substitution).
    """
    def fwd(y_prev, inp):
        DinvLp, Dinvp, gp = inp
        y = jnp.einsum("mij,...mj->...mi", Dinvp, gp) \
            - jnp.einsum("mij,...mj->...mi", DinvLp, y_prev)
        return y, y

    g_t = jnp.moveaxis(g, -3, 0)                # [n_int, ..., Mc, 6]
    y0 = jnp.zeros_like(g_t[0])
    _, y = jax.lax.scan(fwd, y0, (fac.DinvL, fac.Dinv, g_t))

    # interface contributions: f_I -= B_0 (T^{-1} g)_1, but the forward sweep
    # y is not yet T^{-1} g; the 1st block of T^{-1} g needs the backward
    # sweep. Do it here (cheap; reuses Cprime).
    def bwd(v_next, inp):
        cprime, yp = inp
        v = yp - jnp.einsum("mij,...mj->...mi", cprime, v_next)
        return v, v

    _, v = jax.lax.scan(bwd, jnp.zeros_like(y[0]), (fac.Cprime, y),
                        reverse=True)
    fI = -jnp.einsum("mij,...mj->...mi", fac.B0, v[0])
    fJ = -jnp.einsum("mij,...mj->...mi", fac.Cn, v[-1])
    return fI, fJ, jnp.moveaxis(v, 0, -3)


def back_substitute(fac: ChainFactor, v_g, u_I, u_J):
    """Interior displacements from interface solution.

    ``v_g`` is the particular interior solution T^{-1} g returned by
    :func:`condense_loads` (shape [..., n_int, Mc, 6]); the homogeneous
    correction uses the stored Z columns:  v = v_g - Z0 u_I - Zn u_J.

    ``u_I``, ``u_J``: [..., Mc, 6]. Returns [..., n_int, Mc, 6].
    """
    return v_g - jnp.einsum("pmij,...mj->...pmi", fac.Z0, u_I) \
        - jnp.einsum("pmij,...mj->...pmi", fac.Zn, u_J)


def chain_matvec(K_elems: jnp.ndarray, n_seg: int, conn_coarse, U_I_nodes, v):
    """K @ U for the refined chain system, computed IN the condensed layout.

    The refined global K is block-tridiagonal along each member chain plus
    interface coupling, so its matvec needs no gather/scatter over the
    refined DOF vector — three batched 6x6 einsums on the interior tensor
    and one tiny interface scatter (2 Mc adds into nc nodes).  Used for the
    iterative-refinement residual in float32 scans (in place of a vmapped
    element scatter-add at [S, n_dof] scale).

    ``K_elems``: [Mc * n_seg, 12, 12] member-major refined element stiffness;
    ``U_I_nodes``: [S, nc, 6] interface displacements;
    ``v``: [S, n_int, Mc, 6] interior displacements.
    Returns (y_I [S, nc, 6], y_int [S, n_int, Mc, 6]).
    """
    Mc = K_elems.shape[0] // n_seg
    Ke = K_elems.reshape(Mc, n_seg, 12, 12)

    u1 = U_I_nodes[:, conn_coarse[:, 0]]              # [S, Mc, 6]
    u2 = U_I_nodes[:, conn_coarse[:, 1]]
    # extended chain displacement [S, n_seg+1, Mc, 6]: u_I, v_1..v_n_int, u_J
    vext = jnp.concatenate([u1[:, None], v, u2[:, None]], axis=1)
    # element displacement vectors [S, n_seg, Mc, 12] and element end forces.
    # IMPORTANT for float32 refinement: each element's 12-term dot cancels
    # INSIDE the accumulator (element end forces are O(internal force), tiny
    # vs |K||u|); summing pre-rounded 6x6 block products D v + B v + C v
    # instead loses ~30x residual accuracy (measured at the 9.6k-DOF bench
    # scale: 8e-4 vs 2e-5 refined error).
    u_e = jnp.concatenate([vext[:, :-1], vext[:, 1:]], axis=-1)
    f_e = jnp.einsum("mpij,spmj->spmi", Ke, u_e)      # [S, n_seg, Mc, 12]

    # interior node p (1..n_int) joins element p-1's far end and element p's
    # near end
    y_int = f_e[:, :-1, :, 6:12] + f_e[:, 1:, :, 0:6]
    # interface rows: each chain contributes its first/last element end
    y_I = jnp.zeros_like(U_I_nodes)
    y_I = y_I.at[:, conn_coarse[:, 0]].add(f_e[:, 0, :, 0:6])
    y_I = y_I.at[:, conn_coarse[:, 1]].add(f_e[:, -1, :, 6:12])
    return y_I, y_int


# ---------------------------------------------------------------------------
# Nested (two-level) condensation
# ---------------------------------------------------------------------------

class NestedChainFactor(NamedTuple):
    """Two-level chain factorization: n_seg = n_outer * n_sub.

    Level 1 condenses every sub-chain of ``n_sub`` elements onto its end
    nodes (treating the member as ``n_outer`` independent sub-chains);
    level 2 condenses the resulting chain of ``n_outer`` superelements onto
    the member interfaces.  Two wins over the flat factorization:

    - *float32 stability*: each level factors chains of depth <= ~20, whose
      bending conditioning (~depth^4) stays within f32 range — the flat
      factorization at depth ~327 carries O(1) error (tests/test_large.py);
    - *wall-clock*: the sequential ``lax.scan`` depth drops from
      O(n_seg) to O(n_outer + n_sub) = O(sqrt(n_seg)) while every step
      processes Mc * n_outer chains in parallel instead of Mc.

    ``K_super`` is the member-interface superelement stiffness, identical
    in meaning to :class:`ChainFactor.K_super`.
    """

    K_super: jnp.ndarray     # [Mc, 12, 12]
    fac1: ChainFactor        # level-1: Mc * n_outer chains of n_sub elements
    fac2: ChainFactor        # level-2: Mc chains of n_outer superelements


def nested_split(n_seg: int) -> int:
    """Pick n_sub | n_seg with n_sub and n_seg/n_sub both near sqrt(n_seg)
    (the balanced two-level split).  Raises if n_seg has no divisor pair
    with both factors >= 2."""
    best = None
    for d in range(2, int(np.sqrt(n_seg)) + 1):
        if n_seg % d == 0:
            best = d
    if best is None:
        raise ValueError(
            f"n_seg={n_seg} has no balanced two-level split (prime); "
            "choose a composite refinement level (e.g. 324 = 18*18, "
            "336 = 16*21)")
    return n_seg // best  # n_sub is the larger factor (deeper level 1)


def factor_chains_nested(K_elems: jnp.ndarray, n_seg: int,
                         n_sub: int | None = None) -> NestedChainFactor:
    """Two-level factorization; same inputs/meaning as :func:`factor_chains`."""
    if n_sub is None:
        n_sub = nested_split(n_seg)
    if n_seg % n_sub != 0:
        raise ValueError(f"n_sub={n_sub} must divide n_seg={n_seg}")
    n_outer = n_seg // n_sub
    if n_outer < 2 or n_sub < 2:
        raise ValueError("nested condensation needs n_outer, n_sub >= 2")
    # level 1: member-major [Mc * n_seg] elements are equally (Mc * n_outer)
    # chains of n_sub elements in the same order
    fac1 = factor_chains(K_elems, n_sub)
    # level 2: the sub-chain superelements [Mc * n_outer, 12, 12] form
    # member-major chains of n_outer elements
    fac2 = factor_chains(fac1.K_super, n_outer)
    return NestedChainFactor(K_super=fac2.K_super, fac1=fac1, fac2=fac2)


def _nested_dims(fac: NestedChainFactor):
    Mc = fac.fac2.K_super.shape[0]
    n_outer = fac.fac1.K_super.shape[0] // Mc
    n_sub = fac.fac1.Cprime.shape[0] + 1
    return Mc, n_outer, n_sub


def condense_loads_nested(fac: NestedChainFactor, g):
    """Nested version of :func:`condense_loads` (same contract; the returned
    particular solution is the (v_g1, v_g2) pair for the two levels).

    ``g``: [..., n_int, Mc, 6] with n_int = n_outer * n_sub - 1 in chain-
    position order (position k = 1..n_seg-1).
    """
    Mc, n_outer, n_sub = _nested_dims(fac)
    batch = g.shape[:-3]
    # pad position 0 (the member interface carries no interior load) and
    # view positions as (q, p): k = q * n_sub + p
    gfull = jnp.concatenate(
        [jnp.zeros((*batch, 1, Mc, 6), g.dtype), g], axis=-3)
    gqp = gfull.reshape(*batch, n_outer, n_sub, Mc, 6)

    # level-1 interiors: p = 1..n_sub-1 of every sub-chain q; level-1 chain
    # index c = m * n_outer + q (member-major)
    g1 = jnp.moveaxis(gqp[..., :, 1:, :, :], -4, -2)       # [..., n_sub-1, Mc, n_outer, 6]
    g1 = g1.reshape(*batch, n_sub - 1, Mc * n_outer, 6)
    fI1, fJ1, v_g1 = condense_loads(fac.fac1, g1)
    fI1 = fI1.reshape(*batch, Mc, n_outer, 6)
    fJ1 = fJ1.reshape(*batch, Mc, n_outer, 6)

    # level-2 interior loads at sub-chain boundaries j = 1..n_outer-1
    # (position k = j * n_sub): direct load + both neighbours' condensates
    g2 = gqp[..., 1:, 0, :, :]                             # [..., n_outer-1, Mc, 6]
    g2 = g2 + jnp.moveaxis(fJ1[..., :-1, :], -2, -3) \
        + jnp.moveaxis(fI1[..., 1:, :], -2, -3)
    fI2, fJ2, v_g2 = condense_loads(fac.fac2, g2)

    fI = fI1[..., 0, :] + fI2                              # [..., Mc, 6]
    fJ = fJ1[..., -1, :] + fJ2
    return fI, fJ, (v_g1, v_g2)


def back_substitute_nested(fac: NestedChainFactor, v_g, u_I, u_J):
    """Nested version of :func:`back_substitute` (same contract)."""
    Mc, n_outer, n_sub = _nested_dims(fac)
    v_g1, v_g2 = v_g
    batch = u_I.shape[:-2]

    # level-2: sub-chain boundary displacements [..., n_outer-1, Mc, 6]
    v2 = back_substitute(fac.fac2, v_g2, u_I, u_J)

    # boundary table vb[j], j = 0..n_outer: u_I, v2..., u_J
    vb = jnp.concatenate([u_I[..., None, :, :], v2,
                          u_J[..., None, :, :]], axis=-3)  # [..., n_outer+1, Mc, 6]
    u_sub_I = jnp.moveaxis(vb[..., :-1, :, :], -3, -2)     # [..., Mc, n_outer, 6]
    u_sub_J = jnp.moveaxis(vb[..., 1:, :, :], -3, -2)
    u_sub_I = u_sub_I.reshape(*batch, Mc * n_outer, 6)
    u_sub_J = u_sub_J.reshape(*batch, Mc * n_outer, 6)

    # level-1 interiors [..., n_sub-1, Mc*n_outer, 6]
    v1 = back_substitute(fac.fac1, v_g1, u_sub_I, u_sub_J)

    # reassemble chain-position order: position k = q * n_sub + p
    v1qp = v1.reshape(*batch, n_sub - 1, Mc, n_outer, 6)
    v1qp = jnp.moveaxis(v1qp, -2, -4)                      # [..., n_outer, n_sub-1, Mc, 6]
    # position p = 0 of sub-chain q (q >= 1) is level-2 node j = q
    heads = jnp.concatenate([jnp.zeros((*batch, 1, 1, Mc, 6), v1.dtype),
                             v2[..., :, None, :, :]], axis=-4)
    vfull = jnp.concatenate([heads, v1qp], axis=-3)        # [..., n_outer, n_sub, Mc, 6]
    vfull = vfull.reshape(*batch, n_outer * n_sub, Mc, 6)
    return vfull[..., 1:, :, :]                            # drop position 0


# ---------------------------------------------------------------------------
# A parallel-cyclic-reduction (PCR) chain solver lived here once.  It was
# retired: its factor cost was never repaid by its faster RHS sweeps in any
# real workload, and it was f32-UNSTABLE (NaN pivots even at depth 31).
# git history has the code.
# ---------------------------------------------------------------------------
