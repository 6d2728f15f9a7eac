"""Structured (chain-tridiagonal) entry-major operators for large-mesh PCG.

WHY.  The generic BCSR matvec (``assembly.bcsr_matvec``) stores blocks as
``[nb, 6, 6]`` and state vectors as ``[6n]``.  Written for an accelerator
that padded every ``[*, 6, 6]`` tensor's (6, 6) minor dims to an (8, 128)
vector tile — a 21x physical-traffic multiplier — and ran the per-block
gather/segment_sum poorly; kept until measured on the GPU against the
generic path.

STRUCTURE.  ``refine_model`` numbers interior nodes chain-major
(models/model.py:265-277), so the refined global K is BLOCK-TRIDIAGONAL in
node order — diagonal D_i, super U_i = K[i, i+1], sub L_i = K[i, i-1] —
plus a tiny irregular set (coarse-node couplings at chain ends: 204 blocks
of 50,001 at n_seg=327).  This module stores those bands ENTRY-MAJOR
(``[6, 6, n]``: entries are the leading dims, the long node axis is minor,
so every array tiles perfectly) and evaluates

    y = D x + U shift(x,+1) + L shift(x,-1) + (irregular gather/scatter)

as 108 fused elementwise multiply-adds over [n]-lanes — no per-block
gathers (rel err 7e-15 against the generic path).

The same entry-major treatment covers the block-Jacobi apply and the
sparse-prolongator coarse correction (ops/coarse.py), so the whole
two-level PCG iteration runs gather-free on the bands.  CG state lives as
``[6, n]`` matrices; conversion to/from the flat ``[6n]`` layout happens
once at the solve boundary.

Applicability is decided host-side from the pattern (``plan_structured``):
meshes whose off-diagonal blocks are mostly NOT at +-1 node distance (the
unrefined 21-node jacket, imported models with arbitrary numbering) stay
on the generic path.

Reference role replaced: the dense LAPACK solve at
`JacketAnalysisGUI_v2.py:444,485` (O(n^2) memory) — this path is how the
build reaches ~100k DOF iteratively.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from .assembly import BCSRMatrix

_HI = jax.lax.Precision.HIGHEST


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StructuredPlan:
    """Host-computed band/irregular slot plan for one BCSR pattern.

    d/u/l_idx   [n] int32   block index of the diag / super / sub band
                            entry of each node row (missing -> nb, which
                            gathers a zero row)
    irr_idx     [ni] int32  block indices not on the three bands
    irr_rows/cols [ni]      their block coordinates
    """

    d_idx: jnp.ndarray
    u_idx: jnp.ndarray
    l_idx: jnp.ndarray
    irr_idx: jnp.ndarray
    irr_rows: jnp.ndarray
    irr_cols: jnp.ndarray
    n_nodes: int = dataclasses.field(default=0, metadata=dict(static=True))
    n_blocks: int = dataclasses.field(default=0, metadata=dict(static=True))


def plan_structured(pattern) -> StructuredPlan | None:
    """Classify the pattern's blocks into tridiagonal bands + irregular
    leftovers (host-side, once per mesh).  Returns None when the banded
    fraction is too small for the structured path to pay off."""
    br = np.asarray(pattern.block_rows).astype(np.int64)
    bc = np.asarray(pattern.block_cols).astype(np.int64)
    n = pattern.n_nodes
    nb = pattern.n_blocks
    isd = br == bc
    isu = bc == br + 1
    isl = bc == br - 1
    irr = ~(isd | isu | isl)
    if irr.sum() > 0.2 * nb:
        return None
    d_idx = np.full(n, nb, np.int32)
    u_idx = np.full(n, nb, np.int32)
    l_idx = np.full(n, nb, np.int32)
    d_idx[br[isd]] = np.where(isd)[0]
    u_idx[br[isu]] = np.where(isu)[0]
    l_idx[br[isl]] = np.where(isl)[0]
    return StructuredPlan(
        d_idx=jnp.asarray(d_idx), u_idx=jnp.asarray(u_idx),
        l_idx=jnp.asarray(l_idx),
        irr_idx=jnp.asarray(np.where(irr)[0].astype(np.int32)),
        irr_rows=jnp.asarray(br[irr].astype(np.int32)),
        irr_cols=jnp.asarray(bc[irr].astype(np.int32)),
        n_nodes=int(n), n_blocks=int(nb),
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StructuredOperator:
    """Entry-major device data of one assembled K + two-level
    preconditioner (build once per solve, reuse across CG segments)."""

    D_em: jnp.ndarray       # [6, 6, n] diagonal blocks
    U_em: jnp.ndarray       # [6, 6, n] super-diagonal (zero at chain ends)
    L_em: jnp.ndarray       # [6, 6, n] sub-diagonal
    I_em: jnp.ndarray       # [6, 6, ni] irregular blocks
    irr_rows: jnp.ndarray   # [ni]
    irr_cols: jnp.ndarray   # [ni]
    Dinv_em: jnp.ndarray    # [6, 6, n] block-Jacobi inverse
    fmask2: jnp.ndarray     # [6, n] free-DOF mask
    # coarse correction (zero-size placeholders when disabled)
    pb_em: jnp.ndarray      # [K, 6, 6, n] prolongator blocks
    p_cols: jnp.ndarray     # [n, K]
    p_onehot: jnp.ndarray   # [K, n_agg, n] aggregation one-hot (restrict)
    Ac_inv: jnp.ndarray     # [6 n_agg, 6 n_agg]
    cscale: jnp.ndarray     # [6 n_agg]
    n_agg: int = dataclasses.field(default=0, metadata=dict(static=True))

    @property
    def n(self):
        return self.D_em.shape[-1]


def build_structured(A: BCSRMatrix, plan: StructuredPlan, Dinv, fmask,
                     coarse=None) -> StructuredOperator:
    """Repack an assembled BCSR matrix (+ preconditioner data) entry-major
    (device-side, once per solve; four fast [*, 36]-row gathers)."""
    nb = plan.n_blocks
    n = plan.n_nodes
    flat = jnp.concatenate([A.blocks.reshape(nb, 36),
                            jnp.zeros((1, 36), A.blocks.dtype)], axis=0)

    def band(idx):
        return flat[idx].T.reshape(6, 6, n)

    I_em = flat[plan.irr_idx].T.reshape(6, 6, -1)
    if coarse is not None:
        pb_em = jnp.transpose(coarse.p_blocks, (1, 2, 3, 0))  # [K,6,6,n]
        p_cols, Ac_inv, cscale = coarse.p_cols, coarse.Ac_inv, coarse.scale
        n_agg = coarse.n_agg
        # dense per-slot aggregation one-hot: the restriction becomes one
        # contraction over the node axis instead of 6K irregular 1-D
        # segment_sums (entries are 0/1 so the contraction is exact in any
        # dtype)
        p_onehot = (p_cols.T[:, None, :]
                    == jnp.arange(n_agg)[None, :, None]).astype(
                        A.blocks.dtype)                     # [K, n_agg, n]
    else:
        dt = A.blocks.dtype
        pb_em = jnp.zeros((0, 6, 6, n), dt)
        p_cols = jnp.zeros((n, 0), jnp.int32)
        p_onehot = jnp.zeros((0, 0, n), dt)
        Ac_inv = jnp.zeros((0, 0), dt)
        cscale = jnp.zeros((0,), dt)
        n_agg = 0
    return StructuredOperator(
        D_em=band(plan.d_idx), U_em=band(plan.u_idx), L_em=band(plan.l_idx),
        I_em=I_em, irr_rows=plan.irr_rows, irr_cols=plan.irr_cols,
        Dinv_em=jnp.transpose(Dinv, (1, 2, 0)),
        fmask2=fmask.reshape(n, 6).T,
        pb_em=pb_em, p_cols=p_cols, p_onehot=p_onehot, Ac_inv=Ac_inv,
        cscale=cscale, n_agg=n_agg,
    )


def _bmul(B_em, X):
    """y[u] = sum_q B_em[u, q] * X[q] — 36 fused elementwise lane ops."""
    return jnp.einsum("uqn,qn->un", B_em, X, precision=_HI)


def matvec(op: StructuredOperator, X):
    """K @ X in [6, n] layout (bands + irregular corrections)."""
    Xu = jnp.pad(X[:, 1:], ((0, 0), (0, 1)))
    Xl = jnp.pad(X[:, :-1], ((0, 0), (1, 0)))
    y = _bmul(op.D_em, X) + _bmul(op.U_em, Xu) + _bmul(op.L_em, Xl)
    xg = X[:, op.irr_cols]                                 # [6, ni] tiny
    contrib = jnp.einsum("uqe,qe->ue", op.I_em, xg, precision=_HI)
    return y.at[:, op.irr_rows].add(contrib)


def projected_matvec(op: StructuredOperator, X):
    """BC projection (see solve.projected_operator): SPD on free DOFs,
    identity on fixed."""
    fm = op.fmask2
    y = fm * matvec(op, fm * X)
    return y + (1.0 - fm) * X


def precond(op: StructuredOperator, R):
    """Two-level preconditioner in [6, n] layout: block-Jacobi + smoothed
    rigid-body coarse correction (entry-major forms of
    coarse.prolong/restrict/coarse_solve)."""
    z = _bmul(op.Dinv_em, R)
    K = op.pb_em.shape[0]
    if K == 0:
        return z
    n_agg = op.n_agg
    # restrict: rc[agg, q] = sum_slots P^T r — per-slot elementwise block
    # products, then ONE one-hot contraction over the node axis per slot
    rc = jnp.zeros((n_agg, 6), R.dtype)
    for k in range(K):
        c = jnp.einsum("uqn,un->qn", op.pb_em[k], R, precision=_HI)
        rc = rc + jnp.einsum("an,qn->aq", op.p_onehot[k], c, precision=_HI)
    y = op.cscale * jnp.dot(op.Ac_inv, op.cscale * rc.reshape(-1),
                            precision=_HI)
    yc = y.reshape(n_agg, 6)
    # prolong: z[u] += sum_k sum_q pb_em[k,u,q] * yc[p_cols[:,k], q]
    for k in range(K):
        xg = yc[op.p_cols[:, k]].T                          # [6, n]
        z = z + jnp.einsum("uqn,qn->un", op.pb_em[k], xg, precision=_HI)
    return z
