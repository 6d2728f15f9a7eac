"""Golden-record the reference implementation's numerics for parity tests.

Runs the PUBLIC reference (`/root/reference/JacketAnalysisGUI_v2.py`) headlessly
— its physics classes are GUI-independent — on pinned input cases and dumps
every intermediate and final quantity to JSON.  The test suite then asserts
this build matches to 1e-8 relative without needing to import the
reference (or pay its pip-probe import delay) at test time.

Run manually when cases change:  python tests/golden/generate_goldens.py

Note: raschii is not installed in this environment, so the reference runs on
its closed-form Airy fallback (`JacketAnalysisGUI_v2.py:187-196`); goldens
therefore cover the Airy path.  Stokes/Fenton models are validated by physics
residual tests instead (see test_waves.py).
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np

HERE = pathlib.Path(__file__).parent
REF = "/root/reference/JacketAnalysisGUI_v2.py"


def load_reference():
    # Short-circuit the reference's auto-pip so import is instant offline.
    orig = subprocess.check_call
    subprocess.check_call = lambda *a, **k: (_ for _ in ()).throw(
        subprocess.CalledProcessError(1, a[0] if a else "pip"))
    try:
        import importlib.util
        spec = importlib.util.spec_from_file_location("refmod", REF)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        subprocess.check_call = orig
    assert not mod.RASCHII_AVAILABLE
    return mod


def run_case(ref, params, geometry=None):
    """Replicates the computation flow of JacketAnalysisGUI.run_analysis
    (`JacketAnalysisGUI_v2.py:1827-2082`) without the GUI.

    ``geometry``: optional (nodes, members, fixed, top) tuple; default is
    the built-in 3-leg jacket.
    """
    p = params
    section_leg = ref.TubularSection(p["D_leg"], p["t_leg"], "Leg", p["rho_steel"])
    section_brace = ref.TubularSection(p["D_brace"], p["t_brace"], "Brace", p["rho_steel"])

    if geometry is None:
        nodes, members, fixed, top = ref.create_default_3leg_jacket(47.0)
    else:
        nodes, members, fixed, top = geometry
    structure = ref.CustomJacketStructure(nodes, members, section_leg,
                                          section_brace, fixed, top, p["rho_steel"])

    wave = ref.RaschiiWave(p["H"], p["T"], p["d"], p["U_c"], p["wave_model"], p["N_harm"])
    morison = ref.MorisonCalculator(structure, wave, p["wave_dir"],
                                    p["current_dir"], p["Cd"], p["Cm"], p["rho_water"])

    t = p["t_analysis"]
    mres = morison.compute_all_morison_forces(t)

    # wave-kinematics probe points (for unit parity tests)
    probes = []
    for (x, z, tt) in [(0.0, -5.0, 0.0), (10.0, -20.0, 2.0), (-5.0, -0.5, 4.7),
                       (3.0, 2.0, 1.0), (8.0, -49.0, 9.0)]:
        kin = wave.get_kinematics(x, z, tt)
        probes.append(dict(x=x, z=z, t=tt, **{k: float(v) for k, v in kin.items()}))

    scan = morison.find_critical_phase(36)

    fem = ref.FEMSolver(structure, p["E"], p["nu"])

    n_legs = len(top)
    F_axial_N = p["F_axial_kN"] * 1000.0
    F_shear_N = p["F_shear_kN"] * 1000.0
    M_moment = p["M_moment_kNm"] * 1e6
    M_torsion = p["M_torsion_kNm"] * 1e6
    theta = np.deg2rad(90.0 - p["wave_dir"])
    for node in top:
        fem.apply_nodal_force(node, np.array([
            F_shear_N * np.cos(theta) / n_legs,
            F_shear_N * np.sin(theta) / n_legs,
            -F_axial_N / n_legs,
            M_torsion / n_legs,
            M_moment / n_legs,
            0.0]))

    for node_name, force in mres["nodal_forces"].items():
        fv = np.zeros(6)
        fv[:3] = force[:3]
        fem.apply_nodal_force(node_name, fv)

    g = 9.81
    if p["sw_mode"] == "calculated":
        for member in structure.members:
            geom = structure.get_member_geometry(member)
            w = member["section"].mass_per_m * g
            Fw = w * geom["L"] / 2.0
            i1 = structure.node_index[member["node1"]]
            i2 = structure.node_index[member["node2"]]
            fem.F_global[6 * i1 + 2] -= Fw
            fem.F_global[6 * i2 + 2] -= Fw
    elif p["sw_mode"] == "custom":
        sw = p["custom_sw_tonnes"] * 1000 * g / structure.n_nodes
        for i in range(structure.n_nodes):
            fem.F_global[6 * i + 2] -= sw

    fem.apply_boundary_conditions(structure.get_bottom_nodes())
    U = fem.solve()
    reactions = fem.get_reactions()
    internal = fem.get_member_internal_forces(p["fy"])

    return dict(
        params=p,
        wave=dict(k=wave.k, omega=wave.omega, L=wave.L, c=wave.c,
                  steepness=wave.steepness),
        wave_probes=probes,
        morison=dict(
            total_drag=mres["total_drag"].tolist(),
            total_inertia=mres["total_inertia"].tolist(),
            total_morison=mres["total_morison"].tolist(),
            nodal_forces={k: v[:3].tolist() for k, v in mres["nodal_forces"].items()},
            member_details=[
                dict(member=d["member"], drag_kN=d["drag_kN"],
                     inertia_kN=d["inertia_kN"], total_kN=d["total_kN"],
                     submerged_length=d["submerged_length"])
                for d in mres["member_details"]],
        ),
        phase_scan=dict(
            t=[r["t"] for r in scan["all_phases"]],
            total_kN=[r["total_kN"] for r in scan["all_phases"]],
            drag_kN=[r["drag_kN"] for r in scan["all_phases"]],
            inertia_kN=[r["inertia_kN"] for r in scan["all_phases"]],
            critical_t=scan["critical"]["t"],
            critical_total_kN=scan["critical"]["total_kN"],
        ),
        fem=dict(
            F_global=fem.F_global.tolist(),
            U=U.tolist(),
            reactions={k: v.tolist() for k, v in reactions.items()},
            node_list=structure.node_list,
            internal_forces=[
                {k: (float(v) if isinstance(v, (int, float, np.floating)) else v)
                 for k, v in m.items()} for m in internal],
        ),
    )


DEFAULT = dict(
    E=210000.0, nu=0.3, fy=355.0, rho_steel=7850.0, rho_water=1025.0,
    D_leg=2000.0, t_leg=75.0, D_brace=800.0, t_brace=30.0,
    H=17.038, T=9.4, d=50.0, U_c=1.7,
    wave_dir=38.0, current_dir=38.0, wave_model="Airy", N_harm=10,
    Cd=0.7, Cm=2.0,
    F_axial_kN=25100.0, F_shear_kN=2900.0, M_moment_kNm=0.0, M_torsion_kNm=0.0,
    sw_mode="custom", custom_sw_tonnes=1100.0, t_analysis=0.0,
)

VARIANT = dict(DEFAULT)
VARIANT.update(
    H=9.5, T=11.2, d=50.0, U_c=0.9, wave_dir=115.0, current_dir=240.0,
    M_moment_kNm=15000.0, M_torsion_kNm=4200.0,
    sw_mode="calculated", t_analysis=2.35,
)

# shallow water (k d ~ 0.9), no current, no self-weight, oblique heading
SHALLOW = dict(DEFAULT)
SHALLOW.update(
    H=4.2, T=12.5, d=15.0, U_c=0.0, wave_dir=270.0, current_dir=0.0,
    F_axial_kN=8000.0, F_shear_kN=900.0, sw_mode="none", t_analysis=5.1,
)


def custom_tower_geometry():
    """A NON-default structure (4-leg square tower, X-braced one bay) so
    golden parity also covers user-built geometry, not just the preset."""
    s = 8.0
    nodes = {}
    for i, (x, y) in enumerate([(-s, -s), (s, -s), (s, s), (-s, s)]):
        nodes[f"L{i+1}B"] = np.array([x, y, -30.0])
        nodes[f"L{i+1}M"] = np.array([0.8 * x, 0.8 * y, -12.0])
        nodes[f"L{i+1}T"] = np.array([0.6 * x, 0.6 * y, 6.0])
    members = []
    for i in range(4):
        members.append(dict(name=f"LEG{i+1}A", node1=f"L{i+1}B",
                            node2=f"L{i+1}M", type="leg"))
        members.append(dict(name=f"LEG{i+1}B", node1=f"L{i+1}M",
                            node2=f"L{i+1}T", type="leg"))
    ring = [1, 2, 3, 4, 1]
    for a, b in zip(ring[:-1], ring[1:]):
        members.append(dict(name=f"HB{a}{b}", node1=f"L{a}M",
                            node2=f"L{b}M", type="h_brace"))
        members.append(dict(name=f"XB{a}{b}", node1=f"L{a}B",
                            node2=f"L{b}M", type="x_brace"))
        members.append(dict(name=f"XT{a}{b}", node1=f"L{a}M",
                            node2=f"L{b}T", type="x_brace"))
    fixed = [f"L{i+1}B" for i in range(4)]
    top = [f"L{i+1}T" for i in range(4)]
    return nodes, members, fixed, top


CUSTOM = dict(DEFAULT)
CUSTOM.update(H=7.5, T=10.0, d=35.0, U_c=1.1, wave_dir=200.0,
              current_dir=155.0, F_axial_kN=12000.0, F_shear_kN=1500.0,
              M_moment_kNm=6000.0, sw_mode="calculated", t_analysis=1.8,
              D_leg=1400.0, t_leg=50.0, D_brace=600.0, t_brace=25.0)


def singular_geometry(ref):
    """The default jacket plus one ORPHAN node (no member touches it):
    its 6 zero rows make K_ff exactly singular, so the reference's
    ``np.linalg.solve`` raises and the except-path least-squares solve
    (`JacketAnalysisGUI_v2.py:484-487`) produces the recorded numbers."""
    nodes, members, fixed, top = ref.create_default_3leg_jacket(47.0)
    nodes = dict(nodes)
    nodes["ZZ_ORPHAN"] = np.array([30.0, 30.0, -10.0])
    return nodes, members, fixed, top


# custom self-weight loads EVERY node (incl. the orphan), making the
# singular system inconsistent as well — the min-norm least-squares branch
# is exercised on both counts
SINGULAR = dict(DEFAULT)
SINGULAR.update(H=6.0, T=10.5, U_c=0.8, t_analysis=1.2)


class _AutogenShim:
    """Headless stand-in for the two GUI attributes the reference's member
    auto-generators touch (`JacketAnalysisGUI_v2.py:1224-1273` read
    ``self.nodes_data``/``self.members_data`` and refresh a Treeview)."""

    def __init__(self, nodes):
        self.nodes_data = nodes
        self.members_data = []

    def refresh_member_list(self):
        pass


def autogen_4leg_geometry(ref):
    """A 4-leg battered tower whose members come from the reference's OWN
    auto-generators (`auto_generate_legs`/`auto_generate_h_braces`,
    `JacketAnalysisGUI_v2.py:1224-1273`) driven headlessly — golden parity
    then covers their exact naming, level-chaining and ring-closure
    semantics, not just hand-listed members."""
    import unittest.mock as mock
    half = [12.0, 10.2, 8.5, 7.0]
    zs = [-45.0, -30.0, -14.0, 5.0]
    corners = [(1.0, 1.0), (-1.0, 1.0), (-1.0, -1.0), (1.0, -1.0)]
    nodes = {}
    for li, leg in enumerate("ABCD"):
        cx, cy = corners[li]
        for lv in range(4):
            nodes[f"{leg}{lv + 1}"] = np.array(
                [cx * half[lv], cy * half[lv], zs[lv]])
    shim = _AutogenShim(nodes)
    with mock.patch.object(ref, "messagebox"):
        ref.JacketAnalysisGUI.auto_generate_legs(shim)
        ref.JacketAnalysisGUI.auto_generate_h_braces(shim)
    fixed = [f"{leg}1" for leg in "ABCD"]
    top = [f"{leg}4" for leg in "ABCD"]
    return nodes, shim.members_data, fixed, top


AUTOGEN = dict(DEFAULT)
AUTOGEN.update(H=8.0, T=10.0, d=48.0, U_c=1.2, wave_dir=75.0,
               current_dir=75.0, F_axial_kN=16000.0, F_shear_kN=1800.0,
               sw_mode="calculated", t_analysis=3.0)


def main():
    ref = load_reference()
    cases = [("default_case", DEFAULT, None),
             ("variant_case", VARIANT, None),
             ("shallow_case", SHALLOW, None),
             ("custom_tower_case", CUSTOM, custom_tower_geometry()),
             ("singular_case", SINGULAR, singular_geometry(ref)),
             ("autogen_4leg_case", AUTOGEN, autogen_4leg_geometry(ref))]
    for name, params, geom in cases:
        out = run_case(ref, params, geometry=geom)
        if geom is not None:
            out["geometry"] = dict(
                nodes={k: np.asarray(v).tolist() for k, v in geom[0].items()},
                members=geom[1], fixed=geom[2], top=geom[3])
        path = HERE / f"{name}.json"
        path.write_text(json.dumps(out))
        print(f"wrote {path} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
