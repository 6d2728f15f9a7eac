"""Linear static solvers: dense (LU / Cholesky) and matrix-free PCG.

Capability parity with ``FEMSolver.solve`` / ``get_reactions``
(`JacketAnalysisGUI_v2.py:473-502`), redesigned for an accelerator:

- Boundary conditions: the reference partitions free/fixed DOFs with numpy
  ``setdiff1d`` and solves the dense free-free block.  The partition depends
  only on the (static) fixed-node mask, so it is computed host-side once and
  the gathered submatrix solve jits with static shapes.
- Small systems: one LAPACK-style dense solve.  ``solve_dense`` mirrors the
  reference's ``np.linalg.solve`` (LU); ``factor_dense``/``solve_factored``
  expose a Cholesky factor-once path so a 360-point phase scan is ONE
  factorization plus a single multi-RHS triangular solve
  instead of 360 dense solves.
- Large systems: matrix-free preconditioned conjugate gradients on the BCSR
  operator with Jacobi or block-Jacobi (6x6 node block) preconditioning.
  Dirichlet BCs are imposed by orthogonal projection (zeroing fixed DOFs in
  the operator and RHS), which keeps the operator SPD without re-indexing
  the sparsity pattern.
- The reference falls back to least-squares when K_ff is singular
  (`JacketAnalysisGUI_v2.py:484-487`); ``solve_dense(..., lstsq_fallback=True)``
  replicates that semantic with a jit-compatible residual check.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# Boundary conditions (host-side, static)
# ---------------------------------------------------------------------------

def free_fixed_dofs(fixed_mask) -> tuple[np.ndarray, np.ndarray]:
    """(free_dofs, fixed_dofs) int arrays from a boolean node mask.

    All 6 DOFs of a fixed node are clamped, like the reference's
    ``apply_boundary_conditions`` (`JacketAnalysisGUI_v2.py:473-479`).
    """
    fixed_mask = np.asarray(fixed_mask)
    dof_fixed = np.repeat(fixed_mask, 6)
    all_dofs = np.arange(dof_fixed.shape[0])
    return all_dofs[~dof_fixed], all_dofs[dof_fixed]


def dof_free_mask(fixed_mask) -> jnp.ndarray:
    """[n_dof] float mask: 1.0 on free DOFs, 0.0 on fixed (for projection)."""
    m = jnp.repeat(jnp.logical_not(jnp.asarray(fixed_mask)), 6)
    return m


def support_spring_nodes(fixed_mask, support_stiffness) -> np.ndarray:
    """Validated foundation-spring diagonal per node ([n_nodes, 6] numpy,
    zero off the supports) — the single prep point for every SSI entry.

    ``support_stiffness`` is a [6] vector (every support identical) or
    [n_fixed, 6], N/mm translations and N*mm/rad rotations.  Negative
    entries are always a sign typo (a non-SPD system would produce silent
    Cholesky NaNs) and all-zero translational stiffness in any direction
    leaves a rigid-body mode; both raise.  Zero ROTATIONAL entries are
    legitimate (a pinned pile head) and pass.
    """
    fixed_nodes = np.where(np.asarray(fixed_mask))[0]
    if fixed_nodes.size == 0:
        raise ValueError("support_stiffness needs at least one support node")
    k = np.broadcast_to(np.asarray(support_stiffness, np.float64),
                        (fixed_nodes.size, 6))
    if not (np.all(k >= 0) and np.isfinite(k).all()):  # negatives, NaN, inf
        raise ValueError("support_stiffness entries must be finite and "
                         f">= 0 (got {np.asarray(support_stiffness)!r})")
    if np.any(k[:, :3].sum(axis=0) == 0):
        raise ValueError(
            "support_stiffness has zero total translational stiffness in "
            "at least one direction: the structure would float (singular "
            "system). Use a stiff spring (e.g. 1e13 N/mm) for a rigid "
            "direction.")
    if fixed_nodes.size == 1 and np.any(k[0, 3:] == 0):
        raise ValueError(
            "a SINGLE support node with a zero rotational spring leaves a "
            "rigid-body rotation about that point (singular system); "
            "pinned (zero-rotation) pile heads need >= 2 NON-COLLINEAR "
            "support nodes or a stiff rotational spring")
    # NOTE (documented limitation): >= 2 support nodes that are COLLINEAR
    # with all-zero rotational springs still leave an unresisted rotation
    # about the line through them.  Node coordinates are not available here,
    # so that geometric case is not detected — the Cholesky will surface it
    # as NaNs.  Real jacket supports (3+ legs) are never collinear.
    ks = np.zeros((np.asarray(fixed_mask).shape[0], 6))
    ks[fixed_nodes] = k
    return ks


def ground_with_springs(K, fixed_mask, support_stiffness, dtype):
    """(K + diag(k), free = ALL DOFs): ground an assembled K through
    validated foundation springs — the shared grounding step of every
    spring-supported eigen/response path (modal, Craig-Bampton, harmonic,
    buckling).  Reaction-recovering paths keep K springless and add the
    diagonal only inside the factorization instead (see api._spring_dfac).
    """
    ks = support_spring_nodes(fixed_mask, support_stiffness)
    idx = jnp.arange(K.shape[0])
    K = K.at[idx, idx].add(jnp.asarray(ks.reshape(-1), dtype))
    return K, idx


# ---------------------------------------------------------------------------
# Dense path
# ---------------------------------------------------------------------------

def solve_dense(K, F, free_dofs, lstsq_fallback: bool = False):
    """U (full-length, zeros at fixed DOFs) from dense K and load vector F.

    Matches ``FEMSolver.solve`` (`JacketAnalysisGUI_v2.py:481-490`): gather
    K_ff and F_f, LU solve.  With ``lstsq_fallback`` the result is replaced
    by a least-squares solution when the LU solution is non-finite (the
    jit-compatible analogue of the reference's try/except).
    """
    free = jnp.asarray(free_dofs)
    K_ff = K[jnp.ix_(free, free)]
    F_f = F[free]
    U_f = jnp.linalg.solve(K_ff, F_f)
    if lstsq_fallback:
        bad = jnp.logical_not(jnp.all(jnp.isfinite(U_f)))
        U_ls = jnp.linalg.lstsq(K_ff, F_f)[0]
        U_f = jnp.where(bad, U_ls, U_f)
    U = jnp.zeros_like(F)
    return U.at[free].set(U_f)


class DenseFactor(NamedTuple):
    chol: jnp.ndarray       # lower Cholesky factor of the SCALED K_ff
    scale: jnp.ndarray      # d = diag(K_ff)^(-1/2) symmetric scaling
    K_ff: jnp.ndarray       # unscaled free-free block (for refinement)
    free_dofs: jnp.ndarray
    n_dof: int


def factor_dense(K, free_dofs) -> DenseFactor:
    """Cholesky-factor the free-free block once (K_ff is SPD for a
    supported structure).

    The system is symmetrically Jacobi-scaled first: beam stiffness entries
    span ~8 orders of magnitude between axial (N/mm) and rotational
    (N*mm/rad) DOFs, and scaling d K d with d = diag(K)^(-1/2) drops the
    effective condition number by orders of magnitude — this is what makes
    the float32 fast path accurate (see also ``solve_factored``'s
    iterative refinement).
    """
    free = jnp.asarray(free_dofs)
    K_ff = K[jnp.ix_(free, free)]
    d = 1.0 / jnp.sqrt(jnp.diagonal(K_ff))
    Ks = K_ff * d[:, None] * d[None, :]
    L = jnp.linalg.cholesky(Ks)
    return DenseFactor(chol=L, scale=d, K_ff=K_ff, free_dofs=free,
                       n_dof=K.shape[0])


def _solve_scaled(fac: DenseFactor, F_f):
    """Solve K_ff X = F_f via the scaled factor; F_f is [n_free, B]."""
    y = fac.scale[:, None] * F_f
    y = jax.scipy.linalg.solve_triangular(fac.chol, y, lower=True)
    y = jax.scipy.linalg.solve_triangular(fac.chol.T, y, lower=False)
    return fac.scale[:, None] * y


def solve_factored(fac: DenseFactor, F, refine_steps: int = 1):
    """Solve for one RHS [n_dof] or a batch [B, n_dof] with one factor.

    The phase-scan fast path: K is time-independent, so 360 wave phases are
    one triangular solve with a [n_free, 360] RHS matrix.
    ``refine_steps`` rounds of iterative refinement (residual matvec + one
    more triangular solve, all O(n^2) vs the O(n^3) factor) recover
    near-working-precision accuracy in float32.
    """
    batched = F.ndim == 2
    Fb = F if batched else F[None]
    F_f = Fb[:, fac.free_dofs].T                       # [n_free, B]
    U_f = _solve_scaled(fac, F_f)
    for _ in range(refine_steps):
        r = F_f - fac.K_ff @ U_f
        U_f = U_f + _solve_scaled(fac, r)
    U = jnp.zeros_like(Fb)
    U = U.at[:, fac.free_dofs].set(U_f.T)
    return U if batched else U[0]


def reactions_dense(K, U, F, fixed_dofs):
    """R = K U - F at the fixed DOFs, reshaped [n_fixed_nodes, 6]
    (`JacketAnalysisGUI_v2.py:492-502`)."""
    R = K @ U - F
    return R[jnp.asarray(fixed_dofs)].reshape(-1, 6)


# ---------------------------------------------------------------------------
# Matrix-free PCG (for BCSR / large meshes)
# ---------------------------------------------------------------------------

class PCGResult(NamedTuple):
    x: jnp.ndarray
    n_iter: jnp.ndarray
    residual: jnp.ndarray


def pcg_init(matvec: Callable, b, precond: Callable, x0=None):
    """Initial CG state ``(x, r, p, rz, it)`` (call under jit)."""
    x = jnp.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r)
    rz = jnp.vdot(r, z)
    return x, r, z, rz, jnp.array(0)


def pcg_run(matvec: Callable, precond: Callable, state, bnorm,
            tol: float, it_stop):
    """Run CG from ``state`` until convergence or ``it >= it_stop``
    (lax.while_loop; call under jit).  The state is re-enterable: a host
    loop can dispatch bounded segments (``it_stop = k*chunk``) and check
    convergence between dispatches (written for an accelerator whose
    runtime watchdog killed a multi-10s device program; kept until
    measured on the GPU)."""
    def cond(state):
        x, r, p, rz, it = state
        return jnp.logical_and(it < it_stop,
                               jnp.linalg.norm(r) / bnorm > tol)

    def body(state):
        x, r, p, rz, it = state
        Ap = matvec(p)
        alpha = rz / jnp.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.vdot(r, z)
        p = z + (rz_new / rz) * p
        return x, r, p, rz_new, it + 1

    return jax.lax.while_loop(cond, body, state)


def pcg_bnorm(b):
    # dtype-aware floor: 1e-300 underflows to 0.0 in float32 and an all-zero
    # RHS would then report residual 0/0 = NaN
    return jnp.maximum(jnp.linalg.norm(b), jnp.finfo(b.dtype).tiny)


def pcg(matvec: Callable, b, precond: Callable = None, x0=None,
        tol: float = 1e-10, maxiter: int = 1000) -> PCGResult:
    """Preconditioned conjugate gradients (lax.while_loop; call under jit).

    ``matvec`` and ``precond`` must be closures over already-masked
    (BC-projected) operators; convergence on relative residual ||r||/||b||.
    """
    if precond is None:
        precond = lambda r: r
    state = pcg_init(matvec, b, precond, x0)
    bnorm = pcg_bnorm(b)
    x, r, p, rz, it = pcg_run(matvec, precond, state, bnorm, tol, maxiter)
    return PCGResult(x=x, n_iter=it, residual=jnp.linalg.norm(r) / bnorm)


def projected_operator(matvec: Callable, free_mask: jnp.ndarray) -> Callable:
    """Impose U=0 on fixed DOFs by projection: A_c x = P A P x + (I-P) x.

    Keeps the operator SPD; the solution of A_c x = P b has exact zeros on
    fixed DOFs and equals the reference's partitioned solve on free DOFs.
    """
    def op(x):
        y = free_mask * matvec(free_mask * x)
        return y + (1.0 - free_mask) * x
    return op


def spd_block_inv(D: jnp.ndarray) -> jnp.ndarray:
    """Batched inverse of small SPD blocks via scaled Cholesky.

    Written for an accelerator whose LU (behind ``jnp.linalg.inv``) had no
    f64 lowering; kept until measured on the GPU.  The blocks here are SPD
    (diagonal blocks of an SPD stiffness with identity fill on fixed DOFs),
    so factor instead with Cholesky after a
    symmetric Jacobi scaling (keeps the factor positive across the ~1e10
    axial-vs-bending magnitude spread; see CLAUDE.md invariants).
    """
    d = jnp.diagonal(D, axis1=-2, axis2=-1)
    s = 1.0 / jnp.sqrt(jnp.where(d > 0, d, 1.0))
    Ds = D * s[..., :, None] * s[..., None, :]
    L = jnp.linalg.cholesky(Ds)
    eye = jnp.broadcast_to(jnp.eye(D.shape[-1], dtype=D.dtype), D.shape)
    Y = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    Ds_inv = jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), Y, lower=False)
    return Ds_inv * s[..., :, None] * s[..., None, :]


def block_jacobi_inverse(diag_blocks: jnp.ndarray,
                         free_mask: jnp.ndarray) -> jnp.ndarray:
    """Masked block-diagonal inverse ``[n, 6, 6]`` (identity at fixed
    nodes) — the data of the block-Jacobi preconditioner, precomputable
    once per factorization (the chunked CG driver reuses it across
    dispatches)."""
    n = diag_blocks.shape[0]
    mask = free_mask.reshape(n, 6)
    eye = jnp.eye(6, dtype=diag_blocks.dtype)
    # zero fixed rows/cols of each block, put 1 on their diagonal
    D = diag_blocks * mask[:, :, None] * mask[:, None, :]
    D = D + eye * (1.0 - mask)[:, :, None]
    return spd_block_inv(D)


def block_jacobi_apply(D_inv: jnp.ndarray) -> Callable:
    """Preconditioner callable from a precomputed masked block inverse."""
    n = D_inv.shape[0]

    def precond(r):
        rb = r.reshape(n, 6)
        zb = jnp.einsum("nij,nj->ni", D_inv, rb)
        return zb.reshape(-1)
    return precond


def block_jacobi_preconditioner(diag_blocks: jnp.ndarray, free_mask: jnp.ndarray) -> Callable:
    """6x6 block-Jacobi preconditioner from BCSR diagonal blocks.

    Fixed DOFs get identity rows so the projected system stays well-posed.
    ``diag_blocks``: [n_nodes, 6, 6].
    """
    return block_jacobi_apply(block_jacobi_inverse(diag_blocks, free_mask))


def jacobi_preconditioner(diag: jnp.ndarray, free_mask: jnp.ndarray) -> Callable:
    """Scalar Jacobi preconditioner; fixed DOFs use 1."""
    d = jnp.where(free_mask > 0, diag, 1.0)
    d = jnp.where(d == 0, 1.0, d)
    inv = 1.0 / d
    return lambda r: inv * r
