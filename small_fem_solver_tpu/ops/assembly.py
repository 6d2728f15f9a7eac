"""Global stiffness assembly: dense scatter-add and block-sparse (BCSR).

Capability parity with ``FEMSolver._assemble_global_stiffness``
(`JacketAnalysisGUI_v2.py:457-467`), redesigned for an accelerator.
The reference scatters each 12x12 element matrix into a dense n_dof x n_dof
numpy array with a Python triple loop; here:

- the *dense* path is one XLA scatter-add of all M*144 contributions
  (fine up to a few thousand DOF, and bit-equivalent to the reference);
- the *block-sparse* path lays K out as 6x6 node blocks in BCSR
  (block compressed sparse row).  The sparsity pattern depends only on
  connectivity, so it is computed once host-side; assembly is then a single
  ``segment_sum`` of per-element 6x6 blocks into their pattern slots, and
  mat-vecs (the hot op of the CG solver) are gather + batched 6x6 matmuls.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def element_dof_indices(conn: jnp.ndarray) -> jnp.ndarray:
    """``dofs[M, 12]``: global DOF indices (6*node + c) for each element
    (`JacketAnalysisGUI_v2.py:462-464`)."""
    c = jnp.arange(6, dtype=conn.dtype)
    d1 = 6 * conn[:, 0:1] + c
    d2 = 6 * conn[:, 1:2] + c
    return jnp.concatenate([d1, d2], axis=-1)


def assemble_dense(K_elems: jnp.ndarray, conn: jnp.ndarray, n_dof: int) -> jnp.ndarray:
    """Dense global K via one scatter-add of all element contributions."""
    dofs = element_dof_indices(conn)
    rows = jnp.broadcast_to(dofs[:, :, None], K_elems.shape)
    cols = jnp.broadcast_to(dofs[:, None, :], K_elems.shape)
    K = jnp.zeros((n_dof, n_dof), dtype=K_elems.dtype)
    return K.at[rows.reshape(-1), cols.reshape(-1)].add(K_elems.reshape(-1))


# ---------------------------------------------------------------------------
# Block CSR (6x6 node blocks)
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BCSRPattern:
    """Block sparsity pattern of the global K (host-computed, once per mesh).

    Sizes are static metadata (shapes must be compile-time constants for
    ``segment_sum``); index arrays are device data so the pattern pytree can
    flow through jit.

    block_rows   [n_blocks] int32   block row index of each stored block
    block_cols   [n_blocks] int32   block col index of each stored block
    row_ptr      [n_nodes+1] int64  CSR row pointers
    elem_slot    [M, 4] int32       destination slot of each element's
                                    (ii, ij, ji, jj) block
    """

    block_rows: jnp.ndarray
    block_cols: jnp.ndarray
    row_ptr: jnp.ndarray
    elem_slot: jnp.ndarray
    # TWO-TIER gather plan (padded with 4M -> a zero row): gathers instead
    # of a segment_sum scatter, and two gathers cover the first two
    # contributions of every block — on refined meshes that is ALL of the
    # blocks except the few original hub nodes (a flat [n_blocks, max_c]
    # table would waste max_c = 8 full-size gathers on a majority of
    # single-contribution blocks).
    # The leftovers (contribution 3+, only at high-degree nodes) go through
    # one small scatter-add.
    gather_idx: jnp.ndarray | None = None     # [n_blocks, <=2]
    extra_idx: jnp.ndarray | None = None      # [n_extra] contribution rows
    extra_slot: jnp.ndarray | None = None     # [n_extra] destination blocks
    n_nodes: int = dataclasses.field(default=0, metadata=dict(static=True))
    n_blocks: int = dataclasses.field(default=0, metadata=dict(static=True))


def build_bcsr_pattern(conn, n_nodes: int) -> BCSRPattern:
    """Host-side pattern construction from int connectivity (runs once per
    mesh).  Uses the native C++ mesh-kit (O(M) hash map) when built,
    otherwise a numpy sort over the 4M block keys."""
    conn = np.asarray(conn)
    try:
        from ..native import bcsr_pattern_native
        out = bcsr_pattern_native(conn, n_nodes)
    except Exception:
        out = None
    if out is not None:
        block_rows, block_cols, row_ptr, elem_slot = out
        gidx, eidx, eslot = _build_gather_table(np.asarray(elem_slot),
                                                int(block_rows.shape[0]))
        return BCSRPattern(
            block_rows=jnp.asarray(block_rows),
            block_cols=jnp.asarray(block_cols),
            row_ptr=jnp.asarray(row_ptr),
            elem_slot=jnp.asarray(elem_slot),
            gather_idx=jnp.asarray(gidx),
            extra_idx=jnp.asarray(eidx),
            extra_slot=jnp.asarray(eslot),
            n_nodes=int(n_nodes),
            n_blocks=int(block_rows.shape[0]),
        )
    i, j = conn[:, 0].astype(np.int64), conn[:, 1].astype(np.int64)
    # the 4 blocks each element touches: (i,i), (i,j), (j,i), (j,j)
    br = np.concatenate([i, i, j, j])
    bc = np.concatenate([i, j, i, j])
    keys = br * n_nodes + bc
    uniq, inverse = np.unique(keys, return_inverse=True)
    n_blocks = uniq.shape[0]
    block_rows = (uniq // n_nodes).astype(np.int32)
    block_cols = (uniq % n_nodes).astype(np.int32)
    row_ptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.add.at(row_ptr, block_rows + 1, 1)
    row_ptr = np.cumsum(row_ptr)
    elem_slot = inverse.reshape(4, -1).T.astype(np.int32)  # [M, 4]
    gidx, eidx, eslot = _build_gather_table(elem_slot, n_blocks)
    return BCSRPattern(
        block_rows=jnp.asarray(block_rows),
        block_cols=jnp.asarray(block_cols),
        row_ptr=jnp.asarray(row_ptr),
        elem_slot=jnp.asarray(elem_slot),
        gather_idx=jnp.asarray(gidx),
        extra_idx=jnp.asarray(eidx),
        extra_slot=jnp.asarray(eslot),
        n_nodes=int(n_nodes),
        n_blocks=int(n_blocks),
    )


def _build_gather_table(elem_slot: np.ndarray, n_blocks: int):
    """Two-tier contribution plan (host-side, once per mesh).

    Returns ``(gidx [n_blocks, <=2], extra_idx [n_extra],
    extra_slot [n_extra])``; pad entries of ``gidx`` point at index 4M (a
    zero contribution row).  Contributions 3+ of high-degree blocks land in
    the extras lists (scatter-added; empty arrays when every block has at
    most two contributions)."""
    slots = elem_slot.T.reshape(-1)                        # column-major = the
    # concatenation order of assemble_bcsr's contribution list
    order = np.argsort(slots, kind="stable").astype(np.int64)
    counts = np.bincount(slots, minlength=n_blocks)
    max_c = max(int(counts.max()), 1)
    starts = np.zeros(n_blocks + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    n_tier = min(max_c, 2)
    gidx = np.full((n_blocks, n_tier), slots.size, np.int32)
    for c in range(n_tier):
        sel = counts > c
        gidx[sel, c] = order[starts[:-1][sel] + c]
    extra_idx, extra_slot = [], []
    for c in range(2, max_c):
        sel = np.where(counts > c)[0]
        extra_idx.append(order[starts[:-1][sel] + c])
        extra_slot.append(sel)
    extra_idx = (np.concatenate(extra_idx).astype(np.int32) if extra_idx
                 else np.zeros(0, np.int32))
    extra_slot = (np.concatenate(extra_slot).astype(np.int32) if extra_slot
                  else np.zeros(0, np.int32))
    return gidx, extra_idx, extra_slot


class BCSRMatrix(NamedTuple):
    pattern: BCSRPattern
    blocks: jnp.ndarray          # [n_blocks, 6, 6]


def assemble_bcsr(K_elems: jnp.ndarray, pattern: BCSRPattern) -> BCSRMatrix:
    """Assemble element matrices into BCSR blocks.

    ``K_elems`` is either the stacked ``[M, 12, 12]`` element matrices or
    the pre-split quadrant stack ``[4M, 6, 6]`` in (ii, ij, ji, jj)-major
    order (see :func:`ops.beams.global_stiffness_quadrants`, which lets XLA
    fuse element construction straight into the gathers below with no
    intermediate 12x12 layout round-trip).

    With the pattern's two-tier gather plan: two row-gathers over the 4M
    element sub-blocks cover every block's first two contributions
    (scatter-free: written for an accelerator whose scatters on (6, 6)-
    shaped rows underfilled its vector tiles), plus one small
    scatter-add for the 3rd+ contributions of high-degree hub blocks.
    Falls back to one ``segment_sum`` for patterns without the plan.
    """
    if K_elems.ndim == 3 and K_elems.shape[-2:] == (12, 12):
        Kii = K_elems[:, 0:6, 0:6]
        Kij = K_elems[:, 0:6, 6:12]
        Kji = K_elems[:, 6:12, 0:6]
        Kjj = K_elems[:, 6:12, 6:12]
        contrib = jnp.concatenate([Kii, Kij, Kji, Kjj], axis=0)    # [4M, 6, 6]
    else:
        contrib = K_elems                                          # [4M, 6, 6]
    if pattern.gather_idx is not None:
        flat = jnp.concatenate(
            [contrib.reshape(-1, 36),
             jnp.zeros((1, 36), contrib.dtype)], axis=0)
        gidx = pattern.gather_idx
        out = flat[gidx[:, 0]]
        for c in range(1, gidx.shape[1]):
            out = out + flat[gidx[:, c]]
        if pattern.extra_idx is not None and pattern.extra_idx.shape[0]:
            out = out.at[pattern.extra_slot].add(flat[pattern.extra_idx])
        return BCSRMatrix(pattern=pattern, blocks=out.reshape(-1, 6, 6))
    slots = jnp.concatenate([pattern.elem_slot[:, 0], pattern.elem_slot[:, 1],
                             pattern.elem_slot[:, 2], pattern.elem_slot[:, 3]])
    blocks = jax.ops.segment_sum(contrib, slots, num_segments=pattern.n_blocks)
    return BCSRMatrix(pattern=pattern, blocks=blocks)


# ---------------------------------------------------------------------------
# Direct-write ("gather-free") assembly
# ---------------------------------------------------------------------------
#
# The two-tier gather assembly above still moves the [4M, 36] quadrant
# stack through HBM twice (write + gather).  But with blocks ordered
# [diag | ij | ji], the off-diagonal data in slot-sorted member order IS
# the assembled result (each duplicate-free edge has exactly one
# contribution), and the diagonal is a padded [2N] contribution list
# summed pairwise — so the element entries can be EMITTED in assembled
# order directly, with one tiny scatter for hub-node 3rd+ contributions
# and duplicate edges.  The geometry inputs are permuted into lane order
# at prepare time (host numpy), so the jitted assembly runs zero gathers:
# it is pure elementwise lane arithmetic (written for an accelerator's
# lane layout; on the H100 the gather path measured faster, see PERF.md).
# Replaces the reference's Python triple-loop scatter
# (`JacketAnalysisGUI_v2.py:457-467`) at full bandwidth.
#
# Limitations: end releases are not supported (use the generic path), and
# changing node coordinates requires re-preparing (host-side numpy fancy
# indexing, microseconds; a uniform geometry scale can be passed at call
# time without re-preparing).

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DirectAssembly:
    """Prepared direct-write assembly for one (mesh, coords).

    ``pattern`` stores the blocks in [diag | ij | ji] order — every BCSR
    consumer in this codebase (matvec, block diagonal, densify, the
    coarse-space and structured-operator builders) keys on
    block_rows/block_cols and is order-agnostic.  ``row_ptr`` is all
    zeros (rows are not contiguous in this order) and ``elem_slot`` holds
    each element's 4 destination slots in the direct order."""

    pattern: BCSRPattern
    # per-lane trace-prepared geometry: c1/c2 [3, L] (m), sect [L] int32
    diag_c1: jnp.ndarray
    diag_c2: jnp.ndarray
    diag_sect: jnp.ndarray
    diag_end: jnp.ndarray        # [2N] 0 = ii contribution, 1 = jj
    diag_mask: jnp.ndarray       # [2N] 0.0 on padding slots
    ij_c1: jnp.ndarray
    ij_c2: jnp.ndarray
    ij_sect: jnp.ndarray
    ji_c1: jnp.ndarray
    ji_c2: jnp.ndarray
    ji_sect: jnp.ndarray
    ex_c1: jnp.ndarray
    ex_c2: jnp.ndarray
    ex_sect: jnp.ndarray
    ex_kind: jnp.ndarray         # [ne] 0=ii, 1=jj, 2=ij, 3=ji
    ex_slot: jnp.ndarray         # [ne] destination block


def _direct_plan(conn: np.ndarray, n_nodes: int):
    """Host-side direct-write plan: block order, per-lane member/end lists,
    extras (hub 3rd+ diagonal contributions and duplicate edges)."""
    i = conn[:, 0].astype(np.int64)
    j = conn[:, 1].astype(np.int64)
    M = i.shape[0]

    def offdiag(rows, cols):
        key = rows * n_nodes + cols
        order = np.argsort(key, kind="stable")
        k_sorted = key[order]
        uniq, first = np.unique(k_sorted, return_index=True)
        members = order[first].astype(np.int32)
        dup_sel = np.ones(M, bool)
        dup_sel[first] = False
        dup_members = order[dup_sel].astype(np.int32)
        dup_slot = np.searchsorted(uniq, k_sorted[dup_sel]).astype(np.int32)
        return uniq, members, dup_members, dup_slot

    ij_keys, ij_members, ij_dup_m, ij_dup_s = offdiag(i, j)
    ji_keys, ji_members, ji_dup_m, ji_dup_s = offdiag(j, i)

    nodes = np.concatenate([i, j])
    member = np.concatenate([np.arange(M), np.arange(M)]).astype(np.int32)
    end = np.concatenate([np.zeros(M, np.int32), np.ones(M, np.int32)])
    order = np.argsort(nodes, kind="stable")
    nodes_s, member_s, end_s = nodes[order], member[order], end[order]
    counts = np.bincount(nodes_s, minlength=n_nodes)
    starts = np.zeros(n_nodes + 1, np.int64)
    starts[1:] = np.cumsum(counts)
    diag_member = np.zeros(2 * n_nodes, np.int32)
    diag_end = np.zeros(2 * n_nodes, np.int32)
    diag_mask = np.zeros(2 * n_nodes, np.float32)
    for c in range(2):
        sel = counts > c
        pos = 2 * np.where(sel)[0] + c
        src = starts[:-1][sel] + c
        diag_member[pos] = member_s[src]
        diag_end[pos] = end_s[src]
        diag_mask[pos] = 1.0
    extra_m, extra_e, extra_slot = [], [], []
    for c in range(2, int(counts.max()) if counts.size else 0):
        sel = np.where(counts > c)[0]
        src = starts[:-1][sel] + c
        extra_m.append(member_s[src])
        extra_e.append(end_s[src])
        extra_slot.append(sel)
    n_ij = ij_keys.shape[0]
    n_ji = ji_keys.shape[0]
    have = bool(extra_m) or ij_dup_m.size or ji_dup_m.size
    if have:
        extra_m = np.concatenate(
            extra_m + [ij_dup_m, ji_dup_m]).astype(np.int32)
        extra_e = np.concatenate(
            extra_e + [np.full(ij_dup_m.shape, 2, np.int32),
                       np.full(ji_dup_m.shape, 3, np.int32)]
        ).astype(np.int32)
        extra_slot = np.concatenate(
            extra_slot + [n_nodes + ij_dup_s, n_nodes + n_ij + ji_dup_s]
        ).astype(np.int32)
    else:
        extra_m = np.zeros(0, np.int32)
        extra_e = np.zeros(0, np.int32)
        extra_slot = np.zeros(0, np.int32)

    block_rows = np.concatenate([
        np.arange(n_nodes), ij_keys // n_nodes, ji_keys // n_nodes
    ]).astype(np.int32)
    block_cols = np.concatenate([
        np.arange(n_nodes), ij_keys % n_nodes, ji_keys % n_nodes
    ]).astype(np.int32)

    # each element's 4 destination slots (ii -> its diag row of node i ...)
    nb = block_rows.shape[0]
    slot_ii = i.astype(np.int32)
    slot_jj = j.astype(np.int32)
    slot_ij = (n_nodes + np.searchsorted(ij_keys, i * n_nodes + j)
               ).astype(np.int32)
    slot_ji = (n_nodes + n_ij + np.searchsorted(ji_keys, j * n_nodes + i)
               ).astype(np.int32)
    elem_slot = np.stack([slot_ii, slot_ij, slot_ji, slot_jj], axis=1)
    return dict(block_rows=block_rows, block_cols=block_cols,
                elem_slot=elem_slot, n_blocks=nb,
                diag_member=diag_member, diag_end=diag_end,
                diag_mask=diag_mask, ij_members=ij_members,
                ji_members=ji_members, extra_m=extra_m, extra_e=extra_e,
                extra_slot=extra_slot)


def prepare_direct_assembly(coords, conn, sect_id,
                            n_nodes: int) -> DirectAssembly:
    """Build the direct-write assembly prep for one mesh + coordinates
    (host-side; numpy fancy indexing + one device_put)."""
    coords = np.asarray(coords)
    conn = np.asarray(conn)
    sect = np.asarray(sect_id).astype(np.int32)
    plan = _direct_plan(conn, n_nodes)
    dtype = coords.dtype
    cT = coords.T                                           # [3, N]

    def lane(members):
        return (jnp.asarray(cT[:, conn[members, 0]]),
                jnp.asarray(cT[:, conn[members, 1]]),
                jnp.asarray(sect[members]))

    d1, d2, ds = lane(plan["diag_member"])
    i1, i2, isx = lane(plan["ij_members"])
    j1, j2, jsx = lane(plan["ji_members"])
    e1, e2, esx = lane(plan["extra_m"])
    pattern = BCSRPattern(
        block_rows=jnp.asarray(plan["block_rows"]),
        block_cols=jnp.asarray(plan["block_cols"]),
        row_ptr=jnp.asarray(np.zeros(n_nodes + 1, np.int64)),
        elem_slot=jnp.asarray(plan["elem_slot"]),
        n_nodes=int(n_nodes), n_blocks=int(plan["n_blocks"]),
    )
    return DirectAssembly(
        pattern=pattern,
        diag_c1=d1, diag_c2=d2, diag_sect=ds,
        diag_end=jnp.asarray(plan["diag_end"]),
        diag_mask=jnp.asarray(plan["diag_mask"].astype(dtype)),
        ij_c1=i1, ij_c2=i2, ij_sect=isx,
        ji_c1=j1, ji_c2=j2, ji_sect=jsx,
        ex_c1=e1, ex_c2=e2, ex_sect=esx,
        ex_kind=jnp.asarray(plan["extra_e"]),
        ex_slot=jnp.asarray(plan["extra_slot"]),
    )


def _lane_axes(c1, c2, scale):
    """Local axes + length on [*]-lane geometry (production conventions of
    ``beams.local_axes``, lane-major form)."""
    d = (c2 - c1) if scale is None else (c2 - c1) * scale
    L = jnp.sqrt(d[0] ** 2 + d[1] ** 2 + d[2] ** 2)
    lx = d / L
    horiz = jnp.sqrt(lx[0] ** 2 + lx[1] ** 2)
    from .beams import _VERTICAL_COS
    vertical = jnp.abs(lx[2]) > _VERTICAL_COS
    zero = jnp.zeros_like(L)
    degen = horiz <= 1e-10
    hsafe = jnp.where(degen, 1.0, horiz)
    lyv = [jnp.where(degen, zero, -lx[1] / hsafe),
           jnp.where(degen, 1.0, lx[0] / hsafe), zero]
    lzv = [lx[1] * lyv[2] - lx[2] * lyv[1],
           lx[2] * lyv[0] - lx[0] * lyv[2],
           lx[0] * lyv[1] - lx[1] * lyv[0]]
    gsafe = jnp.where(horiz <= 1e-30, 1.0, horiz)
    lzg = [lx[1] / gsafe, -lx[0] / gsafe, zero]
    lyg = [lzg[1] * lx[2] - lzg[2] * lx[1],
           lzg[2] * lx[0] - lzg[0] * lx[2],
           lzg[0] * lx[1] - lzg[1] * lx[0]]
    ly = [jnp.where(vertical, a, b) for a, b in zip(lyv, lyg)]
    lz = [jnp.where(vertical, a, b) for a, b in zip(lzv, lzg)]
    return ([lx[0], lx[1], lx[2]], ly, lz), L


def _lane_entries(R, coeffs, keys):
    """Entry vectors for the requested (B1, B2, 3a+b) keys from lane-major
    axes R[axis][component] and [*, 10] stiffness coefficients."""
    from .beams import _KPAT_ENTRIES
    out = {}
    for c, i_, j_, v in _KPAT_ENTRIES:
        B1, a = divmod(i_, 3)
        B2, b = divmod(j_, 3)
        w = v * coeffs[:, c]
        for r in range(3):
            for s in range(3):
                key = (B1, B2, 3 * r + s)
                if key not in keys:
                    continue
                out[key] = out.get(key, 0.0) + w * R[a][r] * R[b][s]
    return out


def _entry_key(q: int, k: int):
    """(B1, B2, 3a+b) source entry of flat entry k of quadrant q."""
    B1q, B2q = divmod(q, 2)
    r, s = divmod(k, 6)
    return (2 * B1q + r // 3, 2 * B2q + s // 3, 3 * (r % 3) + (s % 3))


def assemble_bcsr_direct(prep: DirectAssembly, sections, E, G,
                         scale=None) -> BCSRMatrix:
    """Assemble the global K gather-free from a prepared direct plan.

    ``scale``: optional uniform geometry scale applied at call time (the
    one coordinate change that does not require re-preparing)."""
    from .beams import stiffness_coeffs
    n = prep.pattern.n_nodes

    def lane(c1, c2, sect, keys):
        R, L = _lane_axes(c1, c2, scale)
        coeffs = stiffness_coeffs(L * 1000.0, sections, sect, E, G)
        return _lane_entries(R, coeffs, keys)

    KEYS_DIAG = {_entry_key(0, k) for k in range(36)} \
        | {_entry_key(3, k) for k in range(36)}
    KEYS_IJ = {_entry_key(1, k) for k in range(36)}
    KEYS_JI = {_entry_key(2, k) for k in range(36)}
    KEYS_ALL = {_entry_key(q, k) for q in range(4) for k in range(36)}

    ed = lane(prep.diag_c1, prep.diag_c2, prep.diag_sect, KEYS_DIAG)
    ei = lane(prep.ij_c1, prep.ij_c2, prep.ij_sect, KEYS_IJ)
    ej = lane(prep.ji_c1, prep.ji_c2, prep.ji_sect, KEYS_JI)
    n_extra = int(prep.ex_kind.shape[0])
    if n_extra:
        ee = lane(prep.ex_c1, prep.ex_c2, prep.ex_sect, KEYS_ALL)
        ze = jnp.zeros((n_extra,), prep.diag_c1.dtype)
    zd = jnp.zeros((2 * n,), prep.diag_c1.dtype)
    zi = jnp.zeros((prep.ij_sect.shape[0],), prep.diag_c1.dtype)
    zj = jnp.zeros((prep.ji_sect.shape[0],), prep.diag_c1.dtype)

    rows = []
    for k in range(36):
        e_ii = ed.get(_entry_key(0, k), zd)
        e_jj = ed.get(_entry_key(3, k), zd)
        dvec = jnp.where(prep.diag_end == 0, e_ii, e_jj) * prep.diag_mask
        diag = dvec.reshape(n, 2).sum(-1)
        row = jnp.concatenate([
            diag, ei.get(_entry_key(1, k), zi),
            ej.get(_entry_key(2, k), zj)])
        if n_extra:
            val = jnp.where(
                prep.ex_kind == 0, ee.get(_entry_key(0, k), ze),
                jnp.where(prep.ex_kind == 1, ee.get(_entry_key(3, k), ze),
                          jnp.where(prep.ex_kind == 2,
                                    ee.get(_entry_key(1, k), ze),
                                    ee.get(_entry_key(2, k), ze))))
            row = row.at[prep.ex_slot].add(val)
        rows.append(row)
    blocks = jnp.stack(rows, axis=0).T.reshape(-1, 6, 6)    # [nb, 6, 6]
    return BCSRMatrix(pattern=prep.pattern, blocks=blocks)


def bcsr_matvec(A: BCSRMatrix, x: jnp.ndarray) -> jnp.ndarray:
    """y = K @ x with x of shape [n_dof] or [n_dof, B] (multi-RHS).

    gather x blocks -> batched 6x6 matmul -> segment-sum back to rows.
    """
    n = A.pattern.n_nodes
    multi = x.ndim == 2
    xb = x.reshape(n, 6, -1)                              # [n, 6, B]
    xg = xb[A.pattern.block_cols]                         # [nb, 6, B]
    yb = jnp.einsum("bij,bjk->bik", A.blocks, xg)         # [nb, 6, B]
    y = jax.ops.segment_sum(yb, A.pattern.block_rows, num_segments=n)
    y = y.reshape(6 * n, -1)
    return y if multi else y[:, 0]


def bcsr_block_diagonal(A: BCSRMatrix) -> jnp.ndarray:
    """The 6x6 diagonal blocks ``[n_nodes, 6, 6]`` (for block-Jacobi PCG)."""
    n = A.pattern.n_nodes
    isdiag = A.pattern.block_rows == A.pattern.block_cols
    contrib = jnp.where(isdiag[:, None, None], A.blocks, 0.0)
    return jax.ops.segment_sum(contrib, A.pattern.block_rows, num_segments=n)


def bcsr_to_dense(A: BCSRMatrix) -> jnp.ndarray:
    """Densify (testing only)."""
    n = A.pattern.n_nodes
    K = jnp.zeros((n, 6, n, 6), dtype=A.blocks.dtype)
    K = K.at[A.pattern.block_rows, :, A.pattern.block_cols, :].set(A.blocks)
    return K.reshape(6 * n, 6 * n)
