"""Array-based structural model (mesh) for jacket space frames.

Capability parity with the reference ``CustomJacketStructure``
(`JacketAnalysisGUI_v2.py:302-354`), redesigned for an accelerator:
the reference stores a dict of named nodes and a list of member dicts and
loops over them in Python; here the model is a pytree of packed arrays
(float coordinates, int32 connectivity, per-member section ids, boolean
node masks) so that element-stiffness construction, Morison integration and
assembly are single batched XLA ops.  Node/member *names* are kept host-side
only (static metadata) for I/O, reporting and CSV-export parity.

Conventions (identical to the reference, documented in its Geometry tab at
`JacketAnalysisGUI_v2.py:876-883`): x east, y north, z up, z=0 at mean water
level; coordinates in metres; DOF ordering is 6 per node
(ux, uy, uz, rx, ry, rz), node-major — DOF ``6*i + c`` like the reference's
assembly indexing (`JacketAnalysisGUI_v2.py:462-464`).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.sections import TubeSections, tube_sections

# Member type vocabulary of the reference GUI combo
# (`JacketAnalysisGUI_v2.py:1163`); 'leg' binds the leg section, everything
# else binds the brace section (`JacketAnalysisGUI_v2.py:329`).
MEMBER_TYPES = ("leg", "h_brace", "x_brace", "brace")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class JacketModel:
    """Packed structural model.

    Traced array fields:
      coords     [n_nodes, 3]  node coordinates [m]
      conn       [n_members, 2] int32 node indices (node1, node2)
      sect_id    [n_members]   int32 index into ``sections`` fields
      sections   TubeSections  stacked section properties (mm units)
      fixed_mask [n_nodes]     bool, fully clamped support nodes
      top_mask   [n_nodes]     bool, topside interface nodes

    Static metadata: node/member names and member type strings (host lists).
    """

    coords: jnp.ndarray
    conn: jnp.ndarray
    sect_id: jnp.ndarray
    sections: TubeSections
    fixed_mask: jnp.ndarray
    top_mask: jnp.ndarray
    node_names: tuple = dataclasses.field(default=(), metadata=dict(static=True))
    member_names: tuple = dataclasses.field(default=(), metadata=dict(static=True))
    member_types: tuple = dataclasses.field(default=(), metadata=dict(static=True))
    # Appurtenances (risers, conductors, J-tubes, caissons): hydro-only
    # segments between structural nodes — they attract Morison load (their
    # own diameter, Cd/Cm multipliers) but contribute NO stiffness, mass,
    # weight or buoyancy.  None = no appurtenances (reference semantics).
    # The reference excludes appurtenances outright (its Info tab,
    # `JacketAnalysisGUI_v2.py:141`).
    app_conn: jnp.ndarray | None = None      # [A, 2] int32 node indices
    app_D_mm: jnp.ndarray | None = None      # [A] hydrodynamic OD [mm]
    app_cd_mult: jnp.ndarray | None = None   # [A] drag multiplier
    app_cm_mult: jnp.ndarray | None = None   # [A] inertia multiplier
    app_names: tuple = dataclasses.field(default=(), metadata=dict(static=True))
    # Member end releases: [M] int32 codes (ops.beams.RELEASE_*; bit 0 =
    # node-1 end pinned, bit 1 = node-2 end pinned — the two local bending
    # rotations of that end are statically condensed out of the element).
    # None = every member rigidly framed (reference semantics).
    release: jnp.ndarray | None = None

    # ---------------- sizes ----------------
    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_members(self) -> int:
        return self.conn.shape[0]

    @property
    def n_dof(self) -> int:
        return 6 * self.n_nodes

    @property
    def n_appurtenances(self) -> int:
        return 0 if self.app_conn is None else self.app_conn.shape[0]

    # ---------------- geometry ----------------
    def member_geometry(self):
        """(coord1, coord2, dL, L) for every member; L in metres.

        Batched version of ``CustomJacketStructure.get_member_geometry``
        (`JacketAnalysisGUI_v2.py:342-348`).
        """
        c1 = self.coords[self.conn[:, 0]]
        c2 = self.coords[self.conn[:, 1]]
        dL = c2 - c1
        L = jnp.linalg.norm(dL, axis=-1)
        return c1, c2, dL, L

    # ---------------- host-side index helpers ----------------
    def node_index(self, name: str) -> int:
        return self.node_names.index(name)

    def fixed_node_names(self):
        m = np.asarray(self.fixed_mask)
        return [n for n, f in zip(self.node_names, m) if f]

    def top_node_names(self):
        m = np.asarray(self.top_mask)
        return [n for n, f in zip(self.node_names, m) if f]


def build_model(
    nodes: dict,
    members: Sequence[dict],
    fixed_nodes: Sequence[str],
    top_nodes: Sequence[str],
    leg_section=(2000.0, 75.0),
    brace_section=(800.0, 30.0),
    rho_steel: float = 7850.0,
    dtype=jnp.float64,
) -> JacketModel:
    """Build a packed model from the reference-style inputs.

    ``nodes`` maps name -> (x, y, z) in metres; ``members`` is a sequence of
    dicts with keys name/node1/node2/type (the reference member-list schema,
    `JacketAnalysisGUI_v2.py:327-336`); members of type 'leg' use
    ``leg_section`` = (D_mm, t_mm), all other types use ``brace_section``
    (`JacketAnalysisGUI_v2.py:329`).

    Beyond the reference, a member dict may carry ``release``:
    ``"none"`` (default), ``"pinned1"``, ``"pinned2"`` or ``"pinned"``
    (both ends) — the pinned end transmits axial, shear and torsion but no
    bending moment.  Every non-support node must keep at least one
    rigidly framed member end (otherwise its bending rotations have no
    stiffness and the system is singular); violations raise here with the
    node named.
    """
    node_names = tuple(nodes.keys())
    index = {n: i for i, n in enumerate(node_names)}
    coords = jnp.asarray(np.array([nodes[n] for n in node_names], dtype=np.float64), dtype=dtype)

    conn = np.array([[index[m["node1"]], index[m["node2"]]] for m in members], dtype=np.int32)
    member_types = tuple(m.get("type", "brace") for m in members)
    member_names = tuple(m["name"] for m in members)
    sect_id = np.array([0 if t == "leg" else 1 for t in member_types], dtype=np.int32)

    _REL_CODES = {"none": 0, "": 0, "pinned1": 1, "pinned2": 2,
                  "pinned": 3, "both": 3}
    rel_strs = [str(m.get("release", "none")).lower() for m in members]
    bad = sorted({s for s in rel_strs if s not in _REL_CODES})
    if bad:
        raise ValueError(f"unknown member release {bad}; use "
                         "'none' | 'pinned1' | 'pinned2' | 'pinned'")
    release = np.array([_REL_CODES[s] for s in rel_strs], dtype=np.int32)

    (D_leg, t_leg), (D_brace, t_brace) = leg_section, brace_section
    sections = tube_sections(
        jnp.asarray([D_leg, D_brace], dtype=dtype),
        jnp.asarray([t_leg, t_brace], dtype=dtype),
        rho_steel,
    )

    fixed_mask = np.zeros(len(node_names), dtype=bool)
    top_mask = np.zeros(len(node_names), dtype=bool)
    for n in fixed_nodes:
        fixed_mask[index[n]] = True
    for n in top_nodes:
        top_mask[index[n]] = True

    if release.any():
        # a non-support node whose EVERY attached member end is pinned has
        # no bending stiffness on its rotational DOFs -> singular system
        rigid = np.zeros(len(node_names), dtype=bool)
        rigid[fixed_mask] = True
        for e in range(conn.shape[0]):
            if not (release[e] & 1):
                rigid[conn[e, 0]] = True
            if not (release[e] & 2):
                rigid[conn[e, 1]] = True
        if not rigid.all():
            offenders = [node_names[i] for i in np.where(~rigid)[0]]
            raise ValueError(
                f"node(s) {offenders} have ONLY pinned member ends "
                "attached: their rotations are unrestrained (singular "
                "system). Keep at least one rigidly framed member end at "
                "every non-support node.")

    return JacketModel(
        coords=coords,
        conn=jnp.asarray(conn),
        sect_id=jnp.asarray(sect_id),
        sections=sections,
        fixed_mask=jnp.asarray(fixed_mask),
        top_mask=jnp.asarray(top_mask),
        node_names=node_names,
        member_names=member_names,
        member_types=member_types,
        release=jnp.asarray(release) if release.any() else None,
    )


def add_appurtenances(model: JacketModel,
                      appurtenances: Sequence[dict]) -> JacketModel:
    """Attach hydro-only appurtenance segments to a model.

    Each spec dict: ``name``, ``node1``/``node2`` (structural node names
    — risers and conductors hang on the jacket at guide elevations),
    ``D_mm`` (hydrodynamic OD), optional ``cd_mult``/``cm_mult``
    (shielding or roughness factors, default 1).  The segments attract
    Morison drag/inertia through the same batched kinematics arrays as
    the structural members but add no stiffness, mass, weight or
    buoyancy; their end forces land on the guide nodes by the same lever
    rule.  Returns a new model (the input is untouched).
    """
    if not appurtenances:
        return model
    index = {n: i for i, n in enumerate(model.node_names)}
    conn = np.array([[index[a["node1"]], index[a["node2"]]]
                     for a in appurtenances], dtype=np.int32)
    D = np.array([float(a["D_mm"]) for a in appurtenances])
    cd = np.array([float(a.get("cd_mult", 1.0)) for a in appurtenances])
    cm = np.array([float(a.get("cm_mult", 1.0)) for a in appurtenances])
    if np.any(D <= 0):
        raise ValueError("appurtenance D_mm must be > 0")
    if np.any(cd < 0) or np.any(cm < 0):
        raise ValueError("appurtenance cd_mult/cm_mult must be >= 0")
    dtype = model.coords.dtype
    return dataclasses.replace(
        model,
        app_conn=jnp.asarray(conn),
        app_D_mm=jnp.asarray(D, dtype=dtype),
        app_cd_mult=jnp.asarray(cd, dtype=dtype),
        app_cm_mult=jnp.asarray(cm, dtype=dtype),
        app_names=tuple(a["name"] for a in appurtenances),
    )


def refine_model(model: JacketModel, n_seg: int) -> JacketModel:
    """Subdivide every member into ``n_seg`` equal beam elements.

    This is the mesh-refinement axis the reference cannot reach (its dense
    Python assembly is O(n_dof^2) memory and O(n^3) solve,
    `JacketAnalysisGUI_v2.py:444,485`); used to build the 10k-100k DOF
    benchmark configurations.  New interior nodes are unnamed (generated
    names), carry no fixed/top flags, and inherit the parent member's
    section and type.
    """
    if n_seg <= 1:
        return model
    coords = np.asarray(model.coords)
    conn = np.asarray(model.conn)
    sect_id = np.asarray(model.sect_id)
    n_nodes = coords.shape[0]
    M = conn.shape[0]
    n_int = n_seg - 1  # interior nodes per member

    # interior node coordinates: [M, n_int, 3], laid out member-major so the
    # condensation solver can treat member e's chain as a contiguous block
    c1 = coords[conn[:, 0]]
    c2 = coords[conn[:, 1]]
    s = (np.arange(1, n_seg) / n_seg)[None, :, None]
    interior = c1[:, None, :] + (c2 - c1)[:, None, :] * s

    new_coords = np.concatenate([coords, interior.reshape(-1, 3)], axis=0)

    # chain node ids per member: [M, n_seg+1] = [i, interior..., j]
    int_ids = n_nodes + np.arange(M * n_int).reshape(M, n_int)
    chain = np.concatenate([conn[:, 0:1], int_ids, conn[:, 1:2]], axis=1)
    new_conn = np.stack([chain[:, :-1], chain[:, 1:]], axis=-1).reshape(-1, 2)
    new_sect = np.repeat(sect_id, n_seg)

    fixed = np.zeros(new_coords.shape[0], dtype=bool)
    top = np.zeros(new_coords.shape[0], dtype=bool)
    fixed[:n_nodes] = np.asarray(model.fixed_mask)
    top[:n_nodes] = np.asarray(model.top_mask)

    node_names = tuple(model.node_names) + tuple(
        f"_R{e}_{k}" for e in range(M) for k in range(1, n_seg))
    base = model.member_names if model.member_names else tuple(f"M{e}" for e in range(M))
    member_names = tuple(f"{base[e]}#{k}" for e in range(M) for k in range(n_seg))
    types = model.member_types if model.member_types else ("brace",) * M
    member_types = tuple(types[e] for e in range(M) for _ in range(n_seg))

    # end releases live on the PHYSICAL member ends: the node-1 bit goes to
    # the first segment, the node-2 bit to the last; interior joints rigid
    new_release = None
    if model.release is not None:
        rel = np.asarray(model.release)
        seg_rel = np.zeros((M, n_seg), dtype=np.int32)
        seg_rel[:, 0] |= rel & 1
        seg_rel[:, -1] |= rel & 2
        new_release = jnp.asarray(seg_rel.reshape(-1))

    return JacketModel(
        coords=jnp.asarray(new_coords, dtype=model.coords.dtype),
        conn=jnp.asarray(new_conn.astype(np.int32)),
        sect_id=jnp.asarray(new_sect.astype(np.int32)),
        sections=model.sections,
        fixed_mask=jnp.asarray(fixed),
        top_mask=jnp.asarray(top),
        node_names=node_names,
        member_names=member_names,
        member_types=member_types,
        # appurtenance endpoints are original (coarse) nodes, whose indices
        # are preserved by the refinement layout — carry them unchanged
        app_conn=model.app_conn,
        app_D_mm=model.app_D_mm,
        app_cd_mult=model.app_cd_mult,
        app_cm_mult=model.app_cm_mult,
        app_names=model.app_names,
        release=new_release,
    )
