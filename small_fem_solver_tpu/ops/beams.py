"""Batched 12-DOF 3D Timoshenko beam elements.

Capability parity with the reference ``BeamElement3D``
(`JacketAnalysisGUI_v2.py:360-432`), redesigned for an accelerator:
the reference builds one Python object with explicit 12x12 numpy matrices per
member; here the local-axes rotation, local stiffness and global stiffness of
ALL members are produced as stacked ``[M, 12, 12]`` tensors by vectorized
closed-form expressions — the vertical-member branch becomes a ``where`` mask
and the congruence transform T^T K T a batched product.

Element formulation details replicated exactly (required for 1e-8 parity):

- local x along the member; vertical members (|l_x . z| > 0.999) use
  l_y = z x l_x (fallback (0,1,0) when degenerate), l_z = l_x x l_y;
  non-vertical use l_z = normalize(l_x x z), l_y = l_z x l_x
  (`JacketAnalysisGUI_v2.py:371-387`);
- Timoshenko shear parameters with the reference's y/z cross-pairing
  Phi_y = 12 E Iz / (G Az L^2), Phi_z = 12 E Iy / (G Ay L^2)
  (`JacketAnalysisGUI_v2.py:394-398`);
- stiffness entries and sign pattern of `JacketAnalysisGUI_v2.py:400-421`;
- all lengths in mm (L_mm = 1000 L_m, `JacketAnalysisGUI_v2.py:366`), E and G
  in MPa, so K is N/mm per translation DOF.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .sections import TubeSections

_VERTICAL_COS = 0.999  # |l_x . z| threshold (`JacketAnalysisGUI_v2.py:374`)


def local_axes(dL, L):
    """Rotation matrices ``R[M, 3, 3]`` with rows (l_x, l_y, l_z).

    ``dL``: [M, 3] member vectors (m), ``L``: [M] lengths (m).
    """
    lx = dL / L[:, None]
    cz = lx[:, 2]  # l_x . global_z
    vertical = jnp.abs(cz) > _VERTICAL_COS

    # --- vertical branch (`:374-378`): ly = z x lx, fallback (0,1,0) ---
    zhat = jnp.array([0.0, 0.0, 1.0], dtype=dL.dtype)
    ly_v = jnp.cross(jnp.broadcast_to(zhat, lx.shape), lx)
    ly_v_n = jnp.linalg.norm(ly_v, axis=-1)
    degen = ly_v_n <= 1e-10
    safe_n = jnp.where(degen, 1.0, ly_v_n)
    ly_v = jnp.where(degen[:, None],
                     jnp.array([0.0, 1.0, 0.0], dtype=dL.dtype),
                     ly_v / safe_n[:, None])
    lz_v = jnp.cross(lx, ly_v)

    # --- generic branch (`:380-382`): lz = normalize(lx x z), ly = lz x lx ---
    lz_g = jnp.cross(lx, jnp.broadcast_to(zhat, lx.shape))
    lz_g_n = jnp.linalg.norm(lz_g, axis=-1)
    # guard the normalization for the (masked-out) vertical members
    lz_g = lz_g / jnp.where(lz_g_n <= 1e-30, 1.0, lz_g_n)[:, None]
    ly_g = jnp.cross(lz_g, lx)

    ly = jnp.where(vertical[:, None], ly_v, ly_g)
    lz = jnp.where(vertical[:, None], lz_v, lz_g)
    return jnp.stack([lx, ly, lz], axis=1)  # [M, 3, 3]


def transformation_matrices(R):
    """Block-diagonal ``T[M, 12, 12]`` with R on the 4 diagonal 3x3 blocks
    (`JacketAnalysisGUI_v2.py:384-387`)."""
    M = R.shape[0]
    T = jnp.zeros((M, 12, 12), dtype=R.dtype)
    for b in range(4):
        T = T.at[:, 3 * b:3 * b + 3, 3 * b:3 * b + 3].set(R)
    return T


# Constant 12x12 pattern matrices: K_local = sum_c coeff_c(m) * _KPAT[c].
# One per independent stiffness coefficient of `JacketAnalysisGUI_v2.py:400-421`
# (axial; 12bz, 6bzL, (4+Phi_y)bzL^2, (2-Phi_y)bzL^2; same for y-bending with
# the reference's sign pattern; torsion).  Expressing K_local as a single
# [M, 10] x [10, 144] contraction turns element-stiffness construction into
# one matmul instead of ~40 scattered writes.
def _build_kpat():
    P = np.zeros((10, 12, 12))

    def sym(c, i, j, v):
        P[c, i, j] = v
        P[c, j, i] = v

    sym(0, 0, 0, 1); sym(0, 6, 6, 1); sym(0, 0, 6, -1)              # alpha
    sym(1, 1, 1, 1); sym(1, 7, 7, 1); sym(1, 1, 7, -1)              # 12 bz
    sym(2, 1, 5, 1); sym(2, 1, 11, 1); sym(2, 7, 5, -1); sym(2, 7, 11, -1)  # 6 bz L
    sym(3, 5, 5, 1); sym(3, 11, 11, 1)                               # (4+Phi_y) bz L^2
    sym(4, 5, 11, 1)                                                 # (2-Phi_y) bz L^2
    sym(5, 2, 2, 1); sym(5, 8, 8, 1); sym(5, 2, 8, -1)              # 12 by
    sym(6, 2, 4, -1); sym(6, 2, 10, -1); sym(6, 8, 4, 1); sym(6, 8, 10, 1)  # 6 by L
    sym(7, 4, 4, 1); sym(7, 10, 10, 1)                               # (4+Phi_z) by L^2
    sym(8, 4, 10, 1)                                                 # (2-Phi_z) by L^2
    sym(9, 3, 3, 1); sym(9, 9, 9, 1); sym(9, 3, 9, -1)              # torsion
    return P.reshape(10, 144)


_KPAT = _build_kpat()

# the ~40 nonzero (coeff, row, col, sign) entries of the pattern stack —
# drives the closed-form global-stiffness construction below
_KPAT_ENTRIES = [
    (c, i, j, float(_KPAT.reshape(10, 12, 12)[c, i, j]))
    for c in range(10) for i in range(12) for j in range(12)
    if _KPAT.reshape(10, 12, 12)[c, i, j] != 0.0
]


def local_stiffness(L_mm, sec: TubeSections, sect_id, E, G, include_shear: bool = True):
    """Stacked local stiffness ``K_local[M, 12, 12]`` in N/mm units.

    Vectorized form of ``BeamElement3D._compute_local_stiffness``
    (`JacketAnalysisGUI_v2.py:389-422`) expressed as one coefficient-by-
    pattern matmul (see ``_build_kpat``).
    """
    coeffs = stiffness_coeffs(L_mm, sec, sect_id, E, G, include_shear)
    pat = jnp.asarray(_KPAT, dtype=L_mm.dtype)             # [10, 144]
    return (coeffs @ pat).reshape(-1, 12, 12)


def stiffness_coeffs(L_mm, sec: TubeSections, sect_id, E, G,
                     include_shear: bool = True):
    """The 10 independent stiffness coefficients ``[M, 10]`` of
    `JacketAnalysisGUI_v2.py:400-421` (axial; z/y bending quads; torsion)."""
    L = L_mm
    A = sec.Ax[sect_id]
    Iy = sec.Iy[sect_id]
    Iz = sec.Iz[sect_id]
    Ix = sec.Ix[sect_id]
    Ay = sec.Ay[sect_id]
    Az = sec.Az[sect_id]

    if include_shear:
        # degenerate sections (Az=0 / Ay=0, e.g. t=0) fall back to
        # Euler-Bernoulli, mirroring the reference's Ay>0/Az>0 guard
        # (`JacketAnalysisGUI_v2.py:394-398`); the safe divisor keeps the
        # masked-out branch finite (and grad-safe)
        Az_safe = jnp.where(Az > 0, Az, 1.0)
        Ay_safe = jnp.where(Ay > 0, Ay, 1.0)
        Phi_y = jnp.where(Az > 0, 12.0 * E * Iz / (G * Az_safe * L**2), 0.0)
        Phi_z = jnp.where(Ay > 0, 12.0 * E * Iy / (G * Ay_safe * L**2), 0.0)
    else:
        Phi_y = jnp.zeros_like(L)
        Phi_z = jnp.zeros_like(L)

    alpha = E * A / L
    bz = E * Iz / ((1.0 + Phi_y) * L**3)
    by = E * Iy / ((1.0 + Phi_z) * L**3)
    tors = G * Ix / L

    return jnp.stack([
        alpha,
        12.0 * bz, 6.0 * bz * L, (4.0 + Phi_y) * bz * L**2,
        (2.0 - Phi_y) * bz * L**2,
        12.0 * by, 6.0 * by * L, (4.0 + Phi_z) * by * L**2,
        (2.0 - Phi_z) * by * L**2,
        tors,
    ], axis=-1)                                            # [M, 10]


def global_stiffness_direct(R, coeffs):
    """Closed-form ``K_global[M, 12, 12]`` from local axes and stiffness
    coefficients — no congruence transform, no 12x12 intermediates.

    With T block-diagonal in R, every 3x3 node block of T^T K_local T is a
    signed sum of rank-one terms:  K_g[3B1+r, 3B2+s] =
    sum_c coeff_c * P_c[3B1+a, 3B2+b] * l_a[r] * l_b[s]  (l_a = rows of R).
    Expanding the ~40 nonzero pattern entries gives pure elementwise
    multiply-adds over [M]-major arrays — vector-friendly with members on
    lanes, vs. the batched congruence whose [M, 12, 12, 12] broadcast
    intermediates made assembly bound by device-memory traffic.  Replaces
    the role of the reference's per-member
    ``T.T @ K_local @ T`` (`JacketAnalysisGUI_v2.py:369`).
    """
    g = _direct_block_grid(R, coeffs)
    rows = [jnp.concatenate(br, axis=-1) for br in g]
    return jnp.concatenate(rows, axis=-2)


def _direct_block_grid(R, coeffs):
    """4x4 grid of [M, 3, 3] global-stiffness blocks (see
    :func:`global_stiffness_direct`)."""
    blocks = [[None] * 4 for _ in range(4)]
    for c, i, j, v in _KPAT_ENTRIES:
        B1, a = divmod(i, 3)
        B2, b = divmod(j, 3)
        term = ((v * coeffs[:, c])[:, None, None]
                * (R[:, a, :, None] * R[:, b, None, :]))
        prev = blocks[B1][B2]
        blocks[B1][B2] = term if prev is None else prev + term
    zero = jnp.zeros_like(R)
    return [[b if b is not None else zero for b in br] for br in blocks]


def global_stiffness_quadrants(R, coeffs):
    """The element stiffness as the quadrant stack ``[4M, 6, 6]`` in
    (ii, ij, ji, jj)-major order — exactly the contribution layout
    :func:`ops.assembly.assemble_bcsr` consumes, skipping the [M, 12, 12]
    intermediate entirely."""
    g = _direct_block_grid(R, coeffs)

    def quad(r0, c0):
        top = jnp.concatenate([g[r0][c0], g[r0][c0 + 1]], axis=-1)
        bot = jnp.concatenate([g[r0 + 1][c0], g[r0 + 1][c0 + 1]], axis=-1)
        return jnp.concatenate([top, bot], axis=-2)        # [M, 6, 6]

    return jnp.concatenate(
        [quad(0, 0), quad(0, 2), quad(2, 0), quad(2, 2)], axis=0)


def congruence(T, K):
    """Batched ``T^T K T`` for [M, 12, 12] stacks, as broadcast-multiply
    reductions.

    Written for an accelerator that lowered tiny batched matmuls (12x12
    per batch element) onto mostly-empty 128x128 matrix tiles; kept until
    measured on the GPU (the FLOPs are trivial; layout is everything).
    """
    TtK = jnp.sum(T[:, :, :, None] * K[:, :, None, :], axis=1)
    return jnp.sum(TtK[:, :, :, None] * T[:, None, :, :], axis=2)


def matmul12(A, B):
    """Batched [M, r, 12] @ [M, 12, 12] -> [M, r, 12] (elementwise form)."""
    return jnp.sum(A[:, :, :, None] * B[:, None, :, :], axis=2)


def matvec12(A, u):
    """Batched matvec ``A[m] @ u[..., m, :]`` with the 12-long contraction
    unrolled into fused multiply-adds (``A``: [M, r, 12], ``u``: [..., M, 12],
    result [..., M, r]).

    Unrolling keeps the wide [..., M] axes on vector lanes instead of
    per-member matrix-unit passes (written for an earlier accelerator;
    kept until measured on the GPU).
    """
    acc = u[..., 0, None] * A[:, :, 0]
    for j in range(1, A.shape[-1]):
        acc = acc + u[..., j, None] * A[:, :, j]
    return acc


# Member end releases ("pinned" connections).  Code is a 2-bit flag:
# bit 0 = node-1 end pinned, bit 1 = node-2 end pinned.  A pinned end
# releases the two LOCAL bending rotations (ry, rz) of that end; axial,
# shear and torsion stay connected (releasing torsion at both ends would
# leave the member free to spin — singular).  The reference has no end
# releases at all (every `BeamElement3D` is rigidly framed,
# `JacketAnalysisGUI_v2.py:360-432`); this is the standard pinned-brace /
# secondary-steel idealization of design practice.
RELEASE_NONE, RELEASE_PIN1, RELEASE_PIN2, RELEASE_PIN_BOTH = 0, 1, 2, 3
_REL_MASKS = np.zeros((4, 12))
_REL_MASKS[1, [4, 5]] = 1.0
_REL_MASKS[2, [10, 11]] = 1.0
_REL_MASKS[3, [4, 5, 10, 11]] = 1.0


def release_transform(K_local, release):
    """Batched kept-DOF expansion ``W [M, 12, 12]`` for end releases.

    ``u_full = W @ u_kept`` (with the kept vector embedded, zeros at the
    released slots): the released rotations take their static, zero-moment
    values ``u_r = -K_rr^{-1} K_rk u_k`` — exact static condensation, so
    ``W^T K_local W`` is the released element stiffness with exactly zero
    rows/columns at the released DOFs, and ``W^T K_G W`` is the consistent
    projection of any other element matrix (geometric stiffness).

    ``A = P K P + (I - P)`` is SPD for bending-rotation releases (the
    rotational block of a beam with clamped translations is PD), so the
    batched solve is Cholesky.
    """
    m = jnp.asarray(_REL_MASKS, dtype=K_local.dtype)[release]   # [M, 12]
    eye = jnp.eye(12, dtype=K_local.dtype)
    A = K_local * m[:, :, None] * m[:, None, :] + eye * (1.0 - m)[:, :, None]
    Lc = jnp.linalg.cholesky(A)
    PK = K_local * m[:, :, None]                                # P K
    X = jax.scipy.linalg.cho_solve((Lc, True), PK)              # A^-1 P K
    return (eye - X) * (1.0 - m)[:, None, :]                    # zero released cols


def apply_releases(K_local, release, W=None):
    """Released local stiffness ``W^T K W`` with exact zeros on the
    released rows/columns (the congruence leaves ~1e-10 roundoff there)."""
    if W is None:
        W = release_transform(K_local, release)
    m = jnp.asarray(_REL_MASKS, dtype=K_local.dtype)[release]
    Kc = congruence(W, K_local)
    return Kc * (1.0 - m)[:, :, None] * (1.0 - m)[:, None, :]


def release_W(coords, conn, sec: TubeSections, sect_id, E, G, release):
    """Local-frame release expansion ``W`` from the RAW (uncondensed)
    element stiffness — for projecting companion element matrices (the
    geometric stiffness in buckling/P-delta) consistently:
    ``K_G_released = W^T K_G W``."""
    c1 = coords[conn[:, 0]]
    c2 = coords[conn[:, 1]]
    L = jnp.linalg.norm(c2 - c1, axis=-1)
    K_local = local_stiffness(L * 1000.0, sec, sect_id, E, G)
    return release_transform(K_local, release)


def element_stiffness(coords, conn, sec: TubeSections, sect_id, E, G,
                      include_shear: bool = True, release=None):
    """All per-element matrices in one shot.

    Returns (K_global [M,12,12], K_local [M,12,12], T [M,12,12], L_m [M]).
    ``K_global = T^T K_local T`` (`JacketAnalysisGUI_v2.py:369`) as a batched
    congruence (see :func:`congruence` for the layout note).
    ``release`` ([M] int codes, see :data:`RELEASE_PIN_BOTH`) statically
    condenses pinned end rotations out of K_local BEFORE the rotation, so
    every consumer (assembly, condensation chains, internal-force recovery)
    sees the released element transparently.
    """
    c1 = coords[conn[:, 0]]
    c2 = coords[conn[:, 1]]
    dL = c2 - c1
    L = jnp.linalg.norm(dL, axis=-1)
    R = local_axes(dL, L)
    T = transformation_matrices(R)
    coeffs = stiffness_coeffs(L * 1000.0, sec, sect_id, E, G, include_shear)
    K_local = (coeffs @ jnp.asarray(_KPAT, dtype=L.dtype)).reshape(-1, 12, 12)
    if release is not None:
        K_local = apply_releases(K_local, release)
    # NOTE: the congruence (not global_stiffness_direct) on purpose — the
    # float32 CONDENSATION chain amplifies the direct form's different
    # rounding pattern ~10x (measured 7e-4 vs 7e-5 relative U at the
    # 9.6k-DOF bench scale); the direct form serves the assembly fast path
    # (element_global_stiffness), where a plain solve follows.
    K_global = congruence(T, K_local)
    return K_global, K_local, T, L


def element_global_stiffness(coords, conn, sec: TubeSections, sect_id, E, G,
                             include_shear: bool = True):
    """``K_global[M, 12, 12]`` only — the assembly fast path.

    Skips materializing T and K_local entirely (closed-form construction,
    see :func:`global_stiffness_direct`); use when element matrices feed
    straight into :func:`ops.assembly.assemble_bcsr`/``assemble_dense``.
    """
    c1 = coords[conn[:, 0]]
    c2 = coords[conn[:, 1]]
    dL = c2 - c1
    L = jnp.linalg.norm(dL, axis=-1)
    R = local_axes(dL, L)
    coeffs = stiffness_coeffs(L * 1000.0, sec, sect_id, E, G, include_shear)
    return global_stiffness_direct(R, coeffs)


def internal_forces(K_local, T, u_elem):
    """End forces in local axes for every member.

    ``u_elem``: [M, 12] element displacement vectors in global axes
    (mm / rad).  Returns (F1 [M, 6], F2 [M, 6]) with the reference's sign
    convention — node-1 forces negated (`JacketAnalysisGUI_v2.py:424-432`).
    Units: N and N*mm.
    """
    u_local = jnp.einsum("mij,mj->mi", T, u_elem)
    F_local = jnp.einsum("mij,mj->mi", K_local, u_local)
    return -F_local[:, :6], F_local[:, 6:]
