"""Device-resident symmetric eigensolvers.

Written for an accelerator that implemented Cholesky/QR/triangular-solve
but NOT ``eigh`` (nor LU, lstsq or any complex solve); kept until measured
on the GPU, where ``jnp.linalg.eigh`` (cuSOLVER) is the default route
(``dynamics._eigh_backend``).  Two pure-jnp pieces:

- :func:`jacobi_eigh` — batched cyclic Jacobi with the round-robin
  PARALLEL ordering: each step applies one block rotation J (m/2 disjoint
  Givens pairs at once) as two [m, m] matmuls, so a full sweep is m-1
  steps instead of m(m-1)/2 sequential rotations.  Runs anywhere jnp
  does, vmaps over leading batch axes, and is exact to roundoff after
  ~10 sweeps for the m <= 64 Ritz blocks used here.
- :func:`subspace_eigh` — Bathe subspace iteration for the SMALLEST
  generalized eigenpairs of (K, M): repeated Jacobi-scaled-Cholesky
  solves K W = M V followed by a Rayleigh-Ritz step solved with
  :func:`jacobi_eigh`.  All dense ops are Cholesky/matmul/QR.

The reference has no dynamics at all (`JacketAnalysisGUI_v2.py` README
exclusion list) — this serves the build's beyond-reference dynamic tier.
"""
from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp


def _round_robin_pairs(m: int) -> list[np.ndarray]:
    """Round-robin tournament schedule: m-1 steps of m/2 disjoint pairs
    covering every (p, q) pair exactly once per sweep (host-side, static).

    Returns a list of [m/2, 2] int arrays.  ``m`` must be even (pad the
    matrix by one identity row/col for odd m)."""
    players = list(range(m))
    steps = []
    for _ in range(m - 1):
        pairs = [(players[i], players[m - 1 - i]) for i in range(m // 2)]
        steps.append(np.array([(min(p, q), max(p, q)) for p, q in pairs],
                              np.int32))
        players = [players[0]] + [players[-1]] + players[1:-1]
    return steps


@partial(jax.jit, static_argnames=("sweeps",))
def jacobi_eigh(A, sweeps: int = 12):
    """Eigendecomposition of symmetric ``A [..., m, m]``: ``(w, V)`` with
    ascending eigenvalues and columns of V the eigenvectors.

    Cyclic Jacobi with parallel (round-robin) ordering; each step builds
    one orthogonal block-rotation J from the m/2 pair rotations and applies
    A <- J^T A J, V <- V J as full matmuls (HIGHEST precision — this is
    solver math).  Quadratically convergent; ``sweeps`` = 12 reaches f64
    roundoff for the m <= 64 blocks used by the subspace/CB solvers.
    """
    m = A.shape[-1]
    dtype = A.dtype
    odd = m % 2 == 1
    if odd:
        pad = [(0, 0)] * (A.ndim - 2) + [(0, 1), (0, 1)]
        A = jnp.pad(A, pad)
        # keep the padded row decoupled at a magnitude comparable to A so
        # rotations with it stay identity-like
        A = A.at[..., m, m].set(1.0)
        m = m + 1
    batch = A.shape[:-2]
    eye = jnp.broadcast_to(jnp.eye(m, dtype=dtype), batch + (m, m))
    V = eye

    # every (sweep, step) iteration shares one traced body: the pair
    # schedule becomes scan data, not unrolled code — unrolling sweeps x
    # (m-1) steps produced HLO large enough to exhaust compile memory on
    # batched f64 problems
    steps = np.tile(np.stack(_round_robin_pairs(m)), (sweeps, 1, 1))

    def one_rotation(carry, pairs):
        A, V = carry
        p = pairs[:, 0]
        q = pairs[:, 1]
        app = A[..., p, p]
        aqq = A[..., q, q]
        apq = A[..., p, q]
        # Rutishauser rotation; t -> 0 when the off-diagonal entry is
        # already negligible RELATIVE to the diagonal (keeps J orthogonal
        # AND avoids 0/0).  All thresholds stay inside float32 exponent
        # range, a guard kept from an accelerator whose software f64 had
        # float32's RANGE (literals like 1e-300, or tau^2 for tau ~ 1e20,
        # became silent infs/NaNs there).
        scale = jnp.abs(app) + jnp.abs(aqq) + 1e-30
        small = jnp.abs(apq) <= 1e-18 * scale
        denom = jnp.where(small, 1.0, 2.0 * apq)
        tau = (aqq - app) / denom
        tau = jnp.clip(tau, -1e15, 1e15)   # tau^2 must not overflow f32 range
        t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(tau * tau + 1.0))
        # exact-diagonal tau = 0 must still give t = 1 (sign(0) = 0 would
        # silently zero the rotation): fall back to the +45-degree rotation
        t = jnp.where(tau == 0.0, 1.0, t)
        t = jnp.where(small, 0.0, t)
        c = 1.0 / jnp.sqrt(t * t + 1.0)
        s = t * c
        # J: identity with [c s; -s c] planted on each (p, q) pair
        J = jnp.zeros_like(A) + eye
        J = J.at[..., p, p].set(c)
        J = J.at[..., q, q].set(c)
        J = J.at[..., p, q].set(s)
        J = J.at[..., q, p].set(-s)
        A = jnp.swapaxes(J, -1, -2) @ A @ J
        V = V @ J
        return (A, V), None

    with jax.default_matmul_precision("highest"):
        (A, V), _ = jax.lax.scan(one_rotation, (A, V), jnp.asarray(steps))

    w = jnp.diagonal(A, axis1=-2, axis2=-1)
    if odd:
        # force the decoupled padding eigenvalue to sort LAST, then drop it
        w = w.at[..., -1].set(jnp.inf)
    order = jnp.argsort(w, axis=-1)
    w = jnp.take_along_axis(w, order, axis=-1)
    V = jnp.take_along_axis(V, order[..., None, :], axis=-1)
    if odd:
        w = w[..., :-1]
        V = V[..., :-1, :-1]
    return w, V


@partial(jax.jit, static_argnames=("sweeps",))
def eigh_general_small(A, B, sweeps: int = 12):
    """Generalized symmetric ``A v = lam B v`` for small dense blocks
    (B SPD): reduce through B's Cholesky and call :func:`jacobi_eigh`.
    Returns (lam ascending, V) with V B-orthonormal.

    B is symmetrically diagonal-scaled and given a dtype-relative ridge
    before the Cholesky: Bathe subspace callers pass Gram matrices
    B = W^T M W whose condition number is the SQUARE of the pencil's —
    a plain f32 Cholesky NaNs there (measured cond ~2e8 on the n_seg=2
    chain problem).  The ridge only moves directions whose B-weight is
    already below the dtype noise floor (they carry no information); their
    lam inflate to the top of the ascending spectrum, where subspace
    callers' guard blocks drop them.  At f64 the ridge is ~1e-14 relative
    — invisible at the framework's 1e-8 parity bar.
    """
    m = B.shape[-1]
    d = jnp.diagonal(B, axis1=-2, axis2=-1)
    s = 1.0 / jnp.sqrt(jnp.where(d > 0, d, 1.0))
    Bs = B * s[..., :, None] * s[..., None, :]
    As = A * s[..., :, None] * s[..., None, :]
    ridge = 32.0 * m * jnp.finfo(B.dtype).eps
    Bs = Bs + ridge * jnp.eye(m, dtype=B.dtype)
    L = jnp.linalg.cholesky(Bs)
    Y = jax.scipy.linalg.solve_triangular(L, As, lower=True)
    C = jax.scipy.linalg.solve_triangular(
        L, jnp.swapaxes(Y, -1, -2), lower=True)
    C = 0.5 * (C + jnp.swapaxes(C, -1, -2))
    lam, Vt = jacobi_eigh(C, sweeps=sweeps)
    V = s[..., :, None] * jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(L, -1, -2), Vt, lower=False)
    return lam, V


@partial(jax.jit, static_argnames=("n_modes", "n_extra", "n_iter", "sweeps"))
def subspace_largest(A, n_modes: int, n_extra: int | None = None,
                     n_iter: int = 60, sweeps: int = 12):
    """LARGEST ``n_modes`` eigenpairs of symmetric ``A [n, n]`` by
    Gershgorin-shifted subspace (block power) iteration with QR
    re-orthonormalization.  Returns (lam descending, V orthonormal).

    Serves the buckling pencil, whose governing factors are
    1 / (largest eigenvalues): that spectrum is INDEFINITE (tension-
    stabilized modes carry large-magnitude negative eigenvalues), and
    plain power iteration chases |lam|, so A is shifted by its Gershgorin
    lower bound first — the shifted spectrum is positive with the same
    ordering and eigenvectors.  Accuracy is set by
    ((sigma + lam_{m+1}) / (sigma + lam_i))^(2 n_iter); the governing
    (well-separated) factor converges tightest.
    """
    n = A.shape[-1]
    if n_extra is None:
        n_extra = max(4, n_modes)
    m = min(n_modes + n_extra, n)
    dtype = A.dtype
    # shift by a spectral-radius estimate (16 power iterations): rho =
    # max|lam| >= |lam_min|, and it is TIGHT — the Gershgorin bound is
    # hopelessly loose for dense blocks and a loose shift flattens the
    # convergence ratio ((sigma + lam_{m+1}) / (sigma + lam_i))
    v = jnp.sin(jnp.arange(1, n + 1, dtype=dtype) * 1.61803)
    v = v / jnp.linalg.norm(v)
    with jax.default_matmul_precision("highest"):
        def pwr(_, v):
            w = A @ v
            return w / jnp.linalg.norm(w, axis=-1, keepdims=True)
        v = jax.lax.fori_loop(0, 16, pwr, v)
        rho = jnp.abs(jnp.einsum("...i,...i->...", v, A @ v))
    sigma = 1.05 * rho
    As = A + sigma[..., None, None] * jnp.eye(n, dtype=dtype)
    i = jnp.arange(1, n + 1, dtype=dtype)
    j = jnp.arange(1, m + 1, dtype=dtype)
    V = jnp.sin(i[:, None] * j[None, :] * 2.399963)     # fixed start block
    V, _ = jnp.linalg.qr(V)
    with jax.default_matmul_precision("highest"):
        V = jax.lax.fori_loop(
            0, n_iter, lambda _, V: jnp.linalg.qr(As @ V)[0], V)
        Ar = jnp.swapaxes(V, -1, -2) @ (A @ V)          # unshifted Ritz
        Ar = 0.5 * (Ar + jnp.swapaxes(Ar, -1, -2))
        lam, Q = jacobi_eigh(Ar, sweeps=sweeps)
        V = V @ Q
    # ascending -> take the top block, descending
    lam = lam[..., ::-1][..., :n_modes]
    V = V[..., ::-1][..., :n_modes]
    return lam, V


@partial(jax.jit, static_argnames=("n_modes", "n_extra", "n_iter", "sweeps"))
def subspace_eigh(K, M, n_modes: int, n_extra: int | None = None,
                  n_iter: int = 24, sweeps: int = 12):
    """Smallest ``n_modes`` generalized eigenpairs of dense SPD (K, M)
    by Bathe subspace iteration — Cholesky + matmuls only, no full
    ``jnp.linalg.eigh``.

    Batched over leading axes of K/M ([..., n, n]).  Returns
    ``(lam [..., n_modes], V [..., n, n_modes])`` with V M-orthonormal.
    Convergence per iteration is (lam_i / lam_{m+1}); ``n_extra`` guard
    vectors (default max(4, n_modes)) keep that ratio small for the lowest
    modes.  The deterministic start mixes the M-diagonal dominant DOFs with
    a fixed pseudo-random block, the standard Bathe recipe.
    """
    n = K.shape[-1]
    if n_extra is None:
        n_extra = max(4, n_modes)
    m = min(n_modes + n_extra, n)
    dtype = K.dtype

    # Jacobi-scaled Cholesky of K (see solve.factor_dense for why scaling)
    dk = 1.0 / jnp.sqrt(jnp.diagonal(K, axis1=-2, axis2=-1))
    Ks = K * dk[..., :, None] * dk[..., None, :]
    Lk = jnp.linalg.cholesky(Ks)

    def ksolve(Rhs):
        y = jax.scipy.linalg.solve_triangular(
            Lk, dk[..., :, None] * Rhs, lower=True)
        y = jax.scipy.linalg.solve_triangular(
            jnp.swapaxes(Lk, -1, -2), y, lower=False)
        return dk[..., :, None] * y

    # deterministic Bathe start: the M/K diagonal-ratio vector, unit
    # vectors at its largest entries, and one fixed quasi-random vector
    # (reproducible by design — no runtime RNG)
    diag_m = jnp.diagonal(M, axis1=-2, axis2=-1)
    ratio = diag_m / jnp.diagonal(K, axis1=-2, axis2=-1)
    idx = jnp.argsort(-ratio, axis=-1)[..., : m - 2]
    oh = jnp.swapaxes(jax.nn.one_hot(idx, n, dtype=dtype), -1, -2)
    qr_vec = jnp.sin(jnp.arange(1, n + 1, dtype=dtype) * 2.399963)
    qr_vec = jnp.broadcast_to(qr_vec, K.shape[:-2] + (n,))
    V = jnp.concatenate([ratio[..., :, None], oh, qr_vec[..., :, None]],
                        axis=-1)                         # [..., n, m]

    def one_iter(_, carry):
        # one traced body via fori_loop: the unrolled variant's HLO
        # exhausted compile memory on batched f64 chain problems
        V, lam = carry
        with jax.default_matmul_precision("highest"):
            W = ksolve(M @ V)                            # [..., n, m]
            # Rayleigh-Ritz on the iterated block
            Ar = jnp.swapaxes(W, -1, -2) @ (M @ V)       # = W^T K W
            Br = jnp.swapaxes(W, -1, -2) @ (M @ W)
            Ar = 0.5 * (Ar + jnp.swapaxes(Ar, -1, -2))
            Br = 0.5 * (Br + jnp.swapaxes(Br, -1, -2))
            lam, Q = eigh_general_small(Ar, Br, sweeps=sweeps)
            V = W @ Q                                    # M-orthonormal
        return V, lam

    lam0 = jnp.zeros(K.shape[:-2] + (m,), dtype)
    V, lam = jax.lax.fori_loop(0, n_iter, one_iter, (V, lam0))
    return lam[..., :n_modes], V[..., :n_modes]
