"""Distributed preconditioned CG over a row-sharded BCSR stiffness.

The tensor-parallel analog for this workload (SURVEY.md section 2.2): the
global K's 6x6 node-block rows are partitioned across a device-mesh axis
('dof'), each device holds its row slab of the BCSR blocks plus its slice of
the solution/RHS, and the CG iteration runs inside ``shard_map`` with XLA
collectives across devices:

- mat-vec: ``all_gather`` of the (small) solution vector, local gathered
  block matvec, local segment-sum — no scatter across devices;
- dot products / norms: local partial + ``psum``;
- preconditioner: block-Jacobi on the locally-owned diagonal blocks (no
  communication).

Dirichlet BCs by projection (fixed DOFs pinned to identity rows), keeping
the operator SPD, exactly like the single-device path in ``ops/solve.py``.

Host-side prep pads the node count to a multiple of the mesh size and each
device's block count to the per-device maximum (padding blocks are zero and
target the device's first row, so they are numerically inert).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.assembly import BCSRMatrix


class ShardedBCSR(NamedTuple):
    """Row-partitioned BCSR data, leading axis = device."""

    blocks: jnp.ndarray       # [D, Bmax, 6, 6]
    cols: jnp.ndarray         # [D, Bmax] global block-column ids
    local_rows: jnp.ndarray   # [D, Bmax] row id within the device slab
    diag: jnp.ndarray         # [D, rows_per_dev, 6, 6] local diagonal blocks
    rows_per_dev: int
    n_nodes_padded: int


def shard_bcsr(A: BCSRMatrix, n_devices: int) -> ShardedBCSR:
    """Partition a BCSR matrix's block rows into ``n_devices`` equal slabs."""
    br = np.asarray(A.pattern.block_rows)
    bc = np.asarray(A.pattern.block_cols)
    blocks = np.asarray(A.blocks)
    n = A.pattern.n_nodes
    rows_per_dev = -(-n // n_devices)
    n_pad = rows_per_dev * n_devices

    dev = br // rows_per_dev
    counts = np.bincount(dev, minlength=n_devices)
    Bmax = int(counts.max())

    blocks_p = np.zeros((n_devices, Bmax, 6, 6), blocks.dtype)
    cols_p = np.zeros((n_devices, Bmax), np.int32)
    lrows_p = np.zeros((n_devices, Bmax), np.int32)
    for d in range(n_devices):
        sel = dev == d
        k = int(sel.sum())
        blocks_p[d, :k] = blocks[sel]
        cols_p[d, :k] = bc[sel]
        lrows_p[d, :k] = br[sel] - d * rows_per_dev

    diag = np.zeros((n_devices, rows_per_dev, 6, 6), blocks.dtype)
    isdiag = br == bc
    for d in range(n_devices):
        sel = isdiag & (dev == d)
        diag[d, br[sel] - d * rows_per_dev] = blocks[sel]

    return ShardedBCSR(
        blocks=jnp.asarray(blocks_p), cols=jnp.asarray(cols_p),
        local_rows=jnp.asarray(lrows_p), diag=jnp.asarray(diag),
        rows_per_dev=rows_per_dev, n_nodes_padded=n_pad,
    )


def distributed_pcg(A: BCSRMatrix, b, fixed_mask, mesh: Mesh,
                    axis: str = "dof", tol: float = 1e-10,
                    maxiter: int = 1000, coarse=None):
    """Solve K u = b (fixed DOFs pinned to zero) across the mesh.

    ``coarse`` (an ``ops.coarse.CoarseSpace``, BLOCK-SPARSE prolongator)
    adds the smoothed rigid-body-aggregate coarse correction to the
    block-Jacobi preconditioner: the restriction P^T r is a local sparse
    slot einsum + segment_sum + one ``psum`` of the tiny [6 n_agg] coarse
    residual across devices, the coarse inverse mat-vec is replicated, and the
    prolongation is local — so the two-level preconditioner costs one
    small all-reduce per iteration while cutting iteration counts ~7x on
    refined frames (see ops/coarse.py).

    Returns (u [n_dof], n_iter, rel_residual) gathered on the host layout.
    """
    n_devices = mesh.devices.size
    S = shard_bcsr(A, n_devices)
    n = A.pattern.n_nodes
    n_pad = S.n_nodes_padded
    dtype = A.blocks.dtype

    # row-partitioned sparse prolongator slots (zero blocks for padded
    # nodes, so they contribute nothing to the restriction)
    if coarse is not None:
        nagg = coarse.n_agg
        K = coarse.p_cols.shape[1]
        pc_np = np.zeros((n_pad, K), np.int32)
        pb_np = np.zeros((n_pad, K, 6, 6), np.asarray(coarse.p_blocks).dtype)
        pc_np[:n] = np.asarray(coarse.p_cols)
        pb_np[:n] = np.asarray(coarse.p_blocks)
        pc_d = jnp.asarray(pc_np.reshape(n_devices, S.rows_per_dev, K))
        pb_d = jnp.asarray(pb_np.reshape(n_devices, S.rows_per_dev, K, 6, 6),
                           dtype)
        Acinv = jnp.asarray(coarse.Ac_inv, dtype)
        cscale = jnp.asarray(coarse.scale, dtype)
    else:
        nagg = 1
        pc_d = jnp.zeros((n_devices, S.rows_per_dev, 1), jnp.int32)
        pb_d = jnp.zeros((n_devices, S.rows_per_dev, 1, 6, 6), dtype)
        Acinv = jnp.eye(6, dtype=dtype)
        cscale = jnp.zeros((6,), dtype)

    free = np.repeat(~np.asarray(fixed_mask), 6).astype(np.float64)
    free = np.pad(free, (0, 6 * (n_pad - n))).astype(dtype)  # pad rows fixed
    b_pad = np.pad(np.asarray(b), (0, 6 * (n_pad - n))).astype(dtype)

    rows6 = S.rows_per_dev * 6
    fmask_d = jnp.asarray(free.reshape(n_devices, rows6))
    b_d = jnp.asarray((b_pad * free).reshape(n_devices, rows6))

    # block-Jacobi with identity at fixed/padded DOFs
    eye = np.eye(6, dtype=np.float64)
    diag = np.asarray(S.diag, np.float64)
    m = free.reshape(n_devices, S.rows_per_dev, 6)
    Dm = diag * m[..., :, None] * m[..., None, :] + eye * (1.0 - m)[..., None]
    Dinv = jnp.asarray(np.linalg.inv(Dm), dtype)

    spec = P(axis)
    rep = P()

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(spec, spec, spec, spec, spec, spec, spec, spec,
                       rep, rep),
             out_specs=(spec, rep, rep))
    def solve(blocks, cols, lrows, Dinv, fmask, b_local, pc, pb, Acinv,
              cscale):
        blocks, cols, lrows = blocks[0], cols[0], lrows[0]
        Dinv, fmask, b_local = Dinv[0], fmask[0], b_local[0]
        pc, pb = pc[0], pb[0]

        def op(x_local):
            xm = fmask * x_local
            x_full = jax.lax.all_gather(xm, axis, tiled=True).reshape(n_pad, 6)
            xg = x_full[cols]
            yb = jnp.einsum("bij,bj->bi", blocks, xg)
            y = jax.ops.segment_sum(yb, lrows,
                                    num_segments=S.rows_per_dev).reshape(-1)
            return fmask * y + (1.0 - fmask) * x_local

        def precond(r):
            rb = r.reshape(S.rows_per_dev, 6)
            z = jnp.einsum("nij,nj->ni", Dinv, rb).reshape(-1)
            if coarse is None:
                return z
            # smoothed rigid-body coarse correction (ops/coarse.py), sparse
            # form: local slot restriction P^T r (einsum + segment_sum over
            # the locally-owned node rows), one psum of the tiny [6 n_agg]
            # coarse residual across devices, replicated Cholesky solve, local
            # sparse prolongation
            c = jnp.einsum("nkuq,nu->nkq", pb, rb,
                           precision=jax.lax.Precision.HIGHEST)
            rc = jax.ops.segment_sum(c.reshape(-1, 6), pc.reshape(-1),
                                     num_segments=nagg).reshape(-1)
            rc = jax.lax.psum(rc, axis)
            y = jnp.dot(Acinv, cscale * rc,
                        precision=jax.lax.Precision.HIGHEST)
            yb = (cscale * y).reshape(nagg, 6)
            zc = jnp.einsum("nkuq,nkq->nu", pb, yb[pc],
                            precision=jax.lax.Precision.HIGHEST)
            return z + zc.reshape(-1)

        def pdot(a, c):
            return jax.lax.psum(jnp.vdot(a, c), axis)

        x = jnp.zeros_like(b_local)
        r = b_local - op(x)
        z = precond(r)
        p = z
        rz = pdot(r, z)
        bnorm = jnp.sqrt(pdot(b_local, b_local))
        bnorm = jnp.maximum(bnorm, jnp.asarray(1e-30, b_local.dtype))

        def cond(st):
            x, r, p, rz, it = st
            return jnp.logical_and(it < maxiter,
                                   jnp.sqrt(pdot(r, r)) / bnorm > tol)

        def body(st):
            x, r, p, rz, it = st
            Ap = op(p)
            alpha = rz / pdot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = pdot(r, z)
            p = z + (rz_new / rz) * p
            return x, r, p, rz_new, it + 1

        x, r, p, rz, it = jax.lax.while_loop(
            cond, body, (x, r, p, rz, jnp.array(0)))
        res = jnp.sqrt(pdot(r, r)) / bnorm
        return x[None], it, res

    x_d, n_iter, res = solve(S.blocks, S.cols, S.local_rows, Dinv,
                             fmask_d, b_d, pc_d, pb_d, Acinv, cscale)
    u = jnp.asarray(x_d).reshape(-1)[: 6 * n]
    return u, n_iter, res
