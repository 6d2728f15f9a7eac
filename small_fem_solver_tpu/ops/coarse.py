"""Two-level (smoothed rigid-body aggregation) preconditioning for PCG.

Block-Jacobi PCG on a slender-frame stiffness suffers the classic
low-energy-mode problem: smooth global deformations are invisible to a 6x6
nodal smoother, so iteration counts grow ~O(chain length) with refinement
(measured in round 2, docs/ARCHITECTURE.md section 4).  The cure is a
coarse space that carries those modes — and for frames the right tentative
basis is per-aggregate RIGID BODY MODES (the near-null space of the
unconstrained operator), SMOOTHED so the coarse functions are low-energy:

- nodes are partitioned host-side into connected aggregates of ~target
  size (greedy BFS over the member graph; for ``refine_model`` meshes the
  aggregates naturally align with member chains);
- each aggregate carries 6 coarse DOFs (3 translations + 3 rotations about
  its centroid); the TENTATIVE prolongator P_tent maps aggregate rigid
  motion to nodal DOFs, P_i = [[I, -S(r_i)], [0, I]] with r_i the node's
  centroid offset (mm, matching the solver's N/mm units);
- one damped-Jacobi smoothing pass P = (I - omega D_bj^-1 A) P_tent
  removes the inter-aggregate displacement jumps that make piecewise-rigid
  fields high-energy (smoothed aggregation, Vanek/Mandel/Brezina 1996 —
  MEASURED here: unsmoothed aggregation cut iterations only 1.1x; one
  omega = 0.5 pass cuts 6.9x, see below);
- the Galerkin coarse operator A_c = P^T A P is Cholesky-factored once;
  the preconditioner is the additive two-level combination
  M^-1 = D_bj^-1 + P A_c^-1 P^T (sum of SPD terms -> SPD, CG-safe; the
  symmetric multiplicative variant was A/B'd and its 2 extra
  matvecs/iteration were not repaid: 589-900 iterations either way).

SPARSE PROLONGATOR (round 5).  P is stored BLOCK-SPARSE, not dense: each
node belongs to exactly one aggregate, and one smoothing pass spreads a
node's row only to the aggregates of its graph neighbours, so node i's
P-row has K_i = |{agg(j) : j in adj(i) or j = i}| nonzero 6x6 blocks —
1 for chain-interior nodes, 2 at aggregate boundaries, a handful at hubs.
The storage is a padded per-node slot table (``p_cols [n, K]``,
``p_blocks [n, K, 6, 6]``, pad slots hold zero blocks) and every operation
is a gather + batched 6x6 einsum + ``segment_sum``:

- P x_c   : gather coarse blocks by slot column, one einsum         O(nK)
- P^T r   : einsum + segment_sum over slot columns                  O(nK)
- P^T A P : per (ka, kb) slot pair, one einsum over the BCSR
            entries + one segment_sum into the [n_agg^2, 6, 6]
            coarse block table (K^2 passes, build-time only)        O(nnz K^2)

The previous DENSE [6n, 6 n_agg] prolongator needed a multi-GB matmul per
CG iteration at ~100k DOF (28.4 GB, more than the device held); the
sparse form is O(n) per iteration like everything else in the
solver.  ``build_coarse_space_dense`` keeps the dense construction for
small-scale cross-checks (tests/test_pcg_precond.py asserts the two agree
to roundoff).

Measured on the refined jacket (f64, storm-wave RHS): block-Jacobi
4,275 iterations -> two-level 621 at 9,612 DOF (6.9x, tol 1e-10), and
669 iterations at 19,404 DOF (tol 1e-9, solution matches the exact
condensation solver to 2.8e-12) — near-REFINEMENT-INDEPENDENT iteration
counts, the signature of a working coarse space, where block-Jacobi
grows ~O(n_seg).  The distributed variant at n_seg=16 (4,716 DOF) is
asserted >= 3x in tests/test_pcg_precond.py.  This closes BASELINE.md's
"IC-preconditioned CG" role for general sparse meshes (the reference has
one dense LAPACK solve, `/root/reference/JacketAnalysisGUI_v2.py:485`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .assembly import BCSRMatrix, bcsr_matvec

_HI = jax.lax.Precision.HIGHEST


def aggregate_nodes(conn, n_nodes: int, target_size: int = 32) -> np.ndarray:
    """Partition the node graph into connected aggregates of ~target_size
    (host-side, greedy BFS; runs once per mesh).

    Uses the native C++ kit when built (bit-identical traversal order —
    tested in tests/test_native.py); pure-Python BFS otherwise."""
    conn = np.asarray(conn)
    try:
        from ..native import aggregate_nodes_native
        out = aggregate_nodes_native(conn, n_nodes, target_size)
    except Exception:
        out = None
    if out is not None:
        return out
    # adjacency via sorted half-edges
    src = np.concatenate([conn[:, 0], conn[:, 1]])
    dst = np.concatenate([conn[:, 1], conn[:, 0]])
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    ptr = np.searchsorted(src_s, np.arange(n_nodes + 1))

    agg = np.full(n_nodes, -1, dtype=np.int64)
    next_agg = 0
    for seed in range(n_nodes):
        if agg[seed] >= 0:
            continue
        # BFS from the seed over unassigned nodes
        frontier = [seed]
        agg[seed] = next_agg
        count = 1
        while frontier and count < target_size:
            nxt = []
            for u in frontier:
                for v in dst_s[ptr[u]:ptr[u + 1]]:
                    if agg[v] < 0:
                        agg[v] = next_agg
                        nxt.append(v)
                        count += 1
                        if count >= target_size:
                            break
                if count >= target_size:
                    break
            frontier = nxt
        next_agg += 1
    return agg


def aggregates_from_pattern(pattern, target_size: int = 32,
                            max_aggregates: int = 192) -> np.ndarray:
    """Host-side aggregation over the BCSR pattern's node graph (the
    off-diagonal blocks ARE the adjacency).  Run once per mesh, outside
    jit; the result feeds :func:`build_coarse_space`.  ``target_size`` is
    raised as needed to keep the aggregate count <= ``max_aggregates``
    (bounds the dense coarse operator A_c at [6*192]^2 and the
    per-iteration triangular-solve latency)."""
    br = np.asarray(pattern.block_rows)
    bc = np.asarray(pattern.block_cols)
    off = br != bc
    edges = np.stack([br[off], bc[off]], axis=1)
    tsz = max(int(target_size), -(-pattern.n_nodes // max_aggregates))
    return aggregate_nodes(edges, pattern.n_nodes, tsz)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SparsePPlan:
    """Host-computed slot plan for the block-sparse smoothed prolongator
    (once per (pattern, aggregation); pure index bookkeeping).

    p_cols      [n, K] int32   aggregate column of each slot (pad -> 0)
    entry_slot  [nnzA] int32   flat slot (node*K + k) each BCSR entry's
                               smoothing contribution lands in
    tent_slot   [n] int32      flat slot of each node's tentative block
    K                          max slots per node (static)
    """

    p_cols: jnp.ndarray
    entry_slot: jnp.ndarray
    tent_slot: jnp.ndarray
    K: int = dataclasses.field(default=1, metadata=dict(static=True))


def plan_sparse_p(pattern, agg, n_agg: int) -> SparsePPlan:
    """Host-side sparsity plan of the one-pass-smoothed prolongator.

    BCSR entry (i, j) contributes -omega D_i^-1 A_ij Pb_j to P's block at
    (row i, aggregate agg[j]); the tentative block Pb_i lands at
    (i, agg[i]).  The union of those targets per row is the sparse
    pattern."""
    br = np.asarray(pattern.block_rows).astype(np.int64)
    bc = np.asarray(pattern.block_cols).astype(np.int64)
    aggn = np.asarray(agg).astype(np.int64)
    n = pattern.n_nodes
    keys_e = br * n_agg + aggn[bc]
    keys_t = np.arange(n, dtype=np.int64) * n_agg + aggn
    uniq, inv = np.unique(np.concatenate([keys_e, keys_t]),
                          return_inverse=True)
    rows = uniq // n_agg
    counts = np.bincount(rows, minlength=n)
    K = int(counts.max())
    starts = np.zeros(n + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    # uniq is key-sorted, so each row's slots are contiguous
    slot_of_uniq = np.arange(uniq.size, dtype=np.int64) - starts[rows]
    flat = (rows * K + slot_of_uniq).astype(np.int32)
    p_cols = np.zeros((n, K), np.int32)
    p_cols[rows, slot_of_uniq] = (uniq % n_agg).astype(np.int32)
    return SparsePPlan(
        p_cols=jnp.asarray(p_cols),
        entry_slot=jnp.asarray(flat[inv[: keys_e.size]]),
        tent_slot=jnp.asarray(flat[inv[keys_e.size:]]),
        K=K,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CoarseSpace:
    """Smoothed rigid-body coarse space with the BLOCK-SPARSE prolongator.

    ``n_agg`` is static metadata (it shapes reshapes/segment counts), so a
    built CoarseSpace can cross jit boundaries — the chunked CG driver
    passes one into every segment program."""

    p_cols: jnp.ndarray   # [n, K] aggregate column per slot
    p_blocks: jnp.ndarray  # [n, K, 6, 6] smoothed blocks (fixed rows zero)
    L_c: jnp.ndarray      # lower Cholesky of the scaled coarse operator
    scale: jnp.ndarray    # [6 n_agg] symmetric Jacobi scaling of A_c
    Ac_inv: jnp.ndarray   # explicit inverse of the scaled coarse operator
    n_agg: int = dataclasses.field(default=0, metadata=dict(static=True))


def _skew(r):
    z = jnp.zeros_like(r[..., 0])
    return jnp.stack([
        jnp.stack([z, -r[..., 2], r[..., 1]], axis=-1),
        jnp.stack([r[..., 2], z, -r[..., 0]], axis=-1),
        jnp.stack([-r[..., 1], r[..., 0], z], axis=-1),
    ], axis=-2)


def _tentative_blocks(coords, agg, n_agg: int, fixed_mask, dtype):
    """Per-node tentative rigid-body 6x6 blocks Pb (fixed rows zeroed)."""
    n = coords.shape[0]
    coords = jnp.asarray(coords)
    # centroids (metres), offsets in mm to match the N/mm DOF units
    cent = jax.ops.segment_sum(coords, agg, num_segments=n_agg) \
        / jax.ops.segment_sum(jnp.ones((n,), coords.dtype), agg,
                              num_segments=n_agg)[:, None]
    r_mm = (coords - cent[agg]) * 1000.0
    eye3 = jnp.eye(3, dtype=dtype)
    Z3 = jnp.zeros((n, 3, 3), dtype)
    top = jnp.concatenate([jnp.broadcast_to(eye3, (n, 3, 3)),
                           -_skew(r_mm).astype(dtype)], axis=-1)
    bot = jnp.concatenate([Z3, jnp.broadcast_to(eye3, (n, 3, 3))], axis=-1)
    Pb = jnp.concatenate([top, bot], axis=-2)              # [n, 6, 6]
    free = jnp.logical_not(jnp.asarray(fixed_mask)).astype(dtype)
    return Pb * free[:, None, None], free


def _block_jacobi_inverse(A: BCSRMatrix, free):
    """Masked block-diagonal inverse (identity at fixed nodes)."""
    from .assembly import bcsr_block_diagonal
    from .solve import spd_block_inv
    mask = jnp.repeat(free, 6).reshape(-1, 6)
    eye6 = jnp.eye(6, dtype=A.blocks.dtype)
    Dm = bcsr_block_diagonal(A) * mask[:, :, None] * mask[:, None, :] \
        + eye6 * (1.0 - mask)[:, :, None]
    return spd_block_inv(Dm)  # Cholesky-based (see spd_block_inv)


def _factor_coarse(Ac, n_agg: int):
    """Symmetric Jacobi scaling + tiny shift + Cholesky of A_c; inactive
    coarse DOFs (fully fixed aggregates / zero columns) get identity rows
    so the factor stays defined and the correction is exactly zero
    there.

    Also returns the EXPLICIT inverse of the scaled operator (via two
    multi-RHS triangular solves of the factor, build-time only): the
    per-iteration coarse solve is then one [6 n_agg]^2 mat-vec on the
    vector units instead of two sequential triangular solves (triangular
    solves are latency-bound: 6 n_agg dependent steps).
    Rounding differences vs the solve form are O(eps kappa(A_c_scaled))
    and irrelevant to preconditioning quality."""
    d = jnp.diagonal(Ac)
    active = d > 1e-12 * jnp.max(d)
    ds = jnp.where(active, 1.0 / jnp.sqrt(jnp.where(active, d, 1.0)), 0.0)
    Acs = Ac * ds[:, None] * ds[None, :]
    idx = jnp.arange(6 * n_agg)
    Acs = Acs.at[idx, idx].set(jnp.where(active, Acs[idx, idx] + 1e-10, 1.0))
    L = jnp.linalg.cholesky(Acs)
    eye = jnp.eye(6 * n_agg, dtype=Ac.dtype)
    Y = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    Ainv = jax.scipy.linalg.solve_triangular(L.T, Y, lower=False)
    return L, ds, Ainv


def build_coarse_space(A: BCSRMatrix, coords, fixed_mask, agg=None,
                       n_agg: int | None = None, target_size: int = 32,
                       omega: float = 0.5, n_smooth: int = 1,
                       plan: SparsePPlan | None = None) -> CoarseSpace:
    """Build the block-sparse smoothed prolongator and factor
    A_c = P^T A P (once per (mesh, K); everything O(nnz)).

    ``agg``/``n_agg``/``plan``: host-computed aggregate ids
    (:func:`aggregates_from_pattern`), their count, and the slot plan
    (:func:`plan_sparse_p`) — ALL REQUIRED when calling under jit (they
    are host-side graph bookkeeping; n_agg and plan.K must be static);
    computed on the fly otherwise.  ``omega``: damped-Jacobi prolongator
    smoothing weight (the A/B in the module docstring picked 0.5); the
    sparse builder supports ``n_smooth`` in {0, 1} (1 is production; the
    slot plan encodes exactly one pass of support growth).
    """
    if n_smooth not in (0, 1):
        raise ValueError("sparse coarse build supports n_smooth in {0, 1}; "
                         "use build_coarse_space_dense for experiments")
    n = A.pattern.n_nodes
    if agg is None:
        agg = aggregates_from_pattern(A.pattern, target_size)
    if n_agg is None:
        n_agg = int(np.asarray(agg).max()) + 1
    agg = jnp.asarray(agg)
    if plan is None:
        plan = plan_sparse_p(A.pattern, agg, n_agg)
    dtype = A.blocks.dtype
    K = plan.K

    Pb, free = _tentative_blocks(coords, agg, n_agg, fixed_mask, dtype)

    flat = jnp.zeros((n * K, 6, 6), dtype)
    if n_smooth:
        Dinv = _block_jacobi_inverse(A, free)
        br, bc = A.pattern.block_rows, A.pattern.block_cols
        contrib = -omega * jnp.einsum("eup,epq,eqv->euv", Dinv[br], A.blocks,
                                      Pb[bc], precision=_HI)
        flat = jax.ops.segment_sum(contrib, plan.entry_slot,
                                   num_segments=n * K)
    flat = flat.at[plan.tent_slot].add(Pb)
    p_blocks = flat.reshape(n, K, 6, 6) * free[:, None, None, None]

    Ac = galerkin_coarse_operator(A, plan.p_cols, p_blocks, n_agg)
    L_c, ds, Ainv = _factor_coarse(Ac, n_agg)
    return CoarseSpace(p_cols=plan.p_cols, p_blocks=p_blocks, L_c=L_c,
                       scale=ds, Ac_inv=Ainv, n_agg=n_agg)


def galerkin_coarse_operator(A: BCSRMatrix, p_cols, p_blocks,
                             n_agg: int) -> jnp.ndarray:
    """Dense A_c = P^T A P from the sparse P: K^2 (slot-pair) passes of
    one batched 6x6 triple product over the BCSR entries + one
    segment_sum into the [n_agg^2] coarse block table.  Build-time only
    (~nnz * K^2 * 216 flops; no [6n, 6 n_agg] intermediate ever exists)."""
    br, bc = A.pattern.block_rows, A.pattern.block_cols
    K = p_cols.shape[1]
    Ablk = jnp.zeros((n_agg * n_agg, 6, 6), A.blocks.dtype)
    rows_a = p_cols[br]            # [e, K] coarse row of each left slot
    cols_b = p_cols[bc]            # [e, K] coarse col of each right slot
    left = p_blocks[br]            # [e, K, 6, 6]
    right = p_blocks[bc]           # [e, K, 6, 6]
    for ka in range(K):
        for kb in range(K):
            blk = jnp.einsum("eup,euv,evq->epq", left[:, ka], A.blocks,
                             right[:, kb], precision=_HI)
            key = rows_a[:, ka].astype(jnp.int32) * n_agg + cols_b[:, kb]
            Ablk = Ablk + jax.ops.segment_sum(blk, key,
                                              num_segments=n_agg * n_agg)
    return Ablk.reshape(n_agg, n_agg, 6, 6).transpose(0, 2, 1, 3) \
               .reshape(6 * n_agg, 6 * n_agg)


def prolong(cs: CoarseSpace, xc):
    """y = P @ x_c (sparse; [6 n_agg] -> [6n])."""
    xb = xc.reshape(cs.n_agg, 6)
    g = xb[cs.p_cols]                                     # [n, K, 6]
    y = jnp.einsum("nkuq,nkq->nu", cs.p_blocks, g, precision=_HI)
    return y.reshape(-1)


def restrict(cs: CoarseSpace, r):
    """r_c = P^T @ r (sparse; [6n] -> [6 n_agg])."""
    n, K = cs.p_cols.shape
    rb = r.reshape(n, 6)
    c = jnp.einsum("nkuq,nu->nkq", cs.p_blocks, rb, precision=_HI)
    out = jax.ops.segment_sum(c.reshape(n * K, 6), cs.p_cols.reshape(-1),
                              num_segments=cs.n_agg)
    return out.reshape(-1)


def prolongator_dense(cs: CoarseSpace) -> jnp.ndarray:
    """Densify the sparse P to [6n, 6 n_agg] (tests / small-scale only)."""
    n, K = cs.p_cols.shape
    onehot = (cs.p_cols[..., None]
              == jnp.arange(cs.n_agg)[None, None, :]).astype(
                  cs.p_blocks.dtype)                      # [n, K, n_agg]
    Pd = jnp.einsum("nka,nkuq->nuaq", onehot, cs.p_blocks, precision=_HI)
    return Pd.reshape(6 * n, 6 * cs.n_agg)


def coarse_solve(cs, rc):
    """A_c^{-1} rc through the precomputed scaled inverse (one mat-vec;
    see :func:`_factor_coarse` for why not triangular solves)."""
    return cs.scale * jnp.dot(cs.Ac_inv, cs.scale * rc, precision=_HI)


def two_level_preconditioner(block_jacobi, cs: CoarseSpace):
    """Additive two-level preconditioner: D_bj^-1 + P A_c^-1 P^T.

    ``block_jacobi``: the existing nodal smoother callable
    (:func:`.solve.block_jacobi_preconditioner` output).  The sum of two
    SPD operators is SPD, so plain CG applies unchanged.
    """
    def precond(r):
        return block_jacobi(r) + prolong(cs, coarse_solve(cs, restrict(cs, r)))
    return precond


# ---------------------------------------------------------------------------
# Dense reference construction (small-scale cross-checks only)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseCoarseSpace:
    """Dense-P coarse space — the pre-round-5 construction, kept as the
    oracle for the sparse builder (NOT for production: the dense P makes
    every CG iteration a multi-GB matmul at ~100k DOF)."""

    P: jnp.ndarray        # [6n, 6 n_agg]
    L_c: jnp.ndarray
    scale: jnp.ndarray
    Ac_inv: jnp.ndarray
    n_agg: int = dataclasses.field(default=0, metadata=dict(static=True))


def build_coarse_space_dense(A: BCSRMatrix, coords, fixed_mask, agg=None,
                             n_agg: int | None = None, target_size: int = 32,
                             omega: float = 0.5,
                             n_smooth: int = 1) -> DenseCoarseSpace:
    """Dense-P construction (supports any n_smooth); test oracle for
    :func:`build_coarse_space`."""
    n = A.pattern.n_nodes
    if agg is None:
        agg = aggregates_from_pattern(A.pattern, target_size)
    if n_agg is None:
        n_agg = int(np.asarray(agg).max()) + 1
    agg = jnp.asarray(agg)
    dtype = A.blocks.dtype

    Pb, free = _tentative_blocks(coords, agg, n_agg, fixed_mask, dtype)
    free6 = jnp.repeat(free, 6)

    # dense tentative prolongator via one-hot aggregate membership
    onehot = (agg[:, None] == jnp.arange(n_agg)[None, :]).astype(dtype)
    P = jnp.einsum("na,nij->niaj", onehot, Pb).reshape(6 * n, 6 * n_agg)

    Dinv = _block_jacobi_inverse(A, free)

    def dinv_mat(X):
        Xb = X.reshape(n, 6, -1)
        return jnp.einsum("nij,njk->nik", Dinv, Xb).reshape(6 * n, -1)

    # multi-RHS SpMV chunked over the coarse-column axis (bounds the
    # gathered intermediate; the build runs once per (mesh, K))
    def amat(X, chunk: int = 128):
        ncols = X.shape[1]
        if ncols <= chunk:
            return bcsr_matvec(A, X)
        pad = (-ncols) % chunk
        Xp = jnp.pad(X, ((0, 0), (0, pad)))
        Xc = jnp.moveaxis(Xp.reshape(6 * n, -1, chunk), 1, 0)
        Yc = jax.lax.map(lambda xc: bcsr_matvec(A, xc), Xc)
        return jnp.moveaxis(Yc, 0, 1).reshape(6 * n, -1)[:, :ncols]

    for _ in range(n_smooth):
        P = P - omega * dinv_mat(amat(P))
        P = P * free6[:, None]

    Ac = P.T @ amat(P)
    L_c, ds, Ainv = _factor_coarse(Ac, n_agg)
    return DenseCoarseSpace(P=P, L_c=L_c, scale=ds, Ac_inv=Ainv,
                            n_agg=n_agg)


def two_level_preconditioner_dense(block_jacobi, cs: DenseCoarseSpace):
    """Dense-P additive two-level preconditioner (test oracle)."""
    def precond(r):
        return block_jacobi(r) + cs.P @ coarse_solve(cs, cs.P.T @ r)
    return precond
