"""Interactive Tk GUI — capability parity with the reference's 8-tab shell.

Mirrors `JacketAnalysisGUI` (`/root/reference/JacketAnalysisGUI_v2.py:809-2260`):
the same tab set (Node Geometry / Members / Material & Sections / Wave
Parameters / Loads / Run Analysis / Results / Info & Assumptions), node and
member CRUD with fixed/top toggles, leg and horizontal-brace auto-generation,
default geometry + storm parameters, a RUN button streaming the analysis log,
a 3D utilization plot and CSV export — plus JSON model save/load, which the
reference GUI implies but lacks (SURVEY.md section 5).

The GUI is a thin widget layer: every computation delegates to the tested
engine (`models`, `ops`, `api`, `utils`), so it needs no physics of its own.
Launch:  python -m small_fem_solver_tpu.gui
"""
from __future__ import annotations

import tkinter as tk
from tkinter import filedialog, messagebox, ttk

import numpy as np

INFO_TEXT = """\
================================================================
  JAX JACKET STRUCTURAL ANALYSIS — THEORY & ASSUMPTIONS
================================================================

1. COORDINATE SYSTEM
----------------------------------------------------------------
  X-axis: EAST  (+X = East)
  Y-axis: NORTH (+Y = North)
  Z-axis: UP, with Z = 0 at the Mean Water Level (MWL).
  The sea bed lies at Z = -d (d = water depth entered on the Wave
  tab); node coordinates below MWL are therefore negative.

  Directions (wave and current) are COMPASS bearings: degrees
  from North, measured clockwise, giving the direction the wave
  or current travels TOWARD. 0 deg = propagating northward,
  90 deg = eastward. Internally the bearing is converted to a
  mathematical angle theta = 90 - bearing about +Z.

2. UNITS
----------------------------------------------------------------
  Input:    geometry in m; section dimensions in mm;
            topside loads in kN and kNm; wave data in m, s, m/s;
            densities in kg/m3; self-weight in tonnes.
  Internal: length mm, force N, moment N*mm, stress MPa
            (the FEM works in N/mm so E in MPa needs no scaling);
            hydrodynamics in SI (m, N) converted at the load step.
  Output:   member forces in kN/kNm, stresses in MPa,
            displacements in mm, reactions in kN.

3. WAVE KINEMATICS
----------------------------------------------------------------
  Three steady-wave theories, all evaluated through one Fourier
  kernel (so any of them can drive any analysis mode):

  - Airy (linear): valid for low steepness; closed form.
  - Stokes 5th order (Fenton 1985 coefficients): moderate
    steepness in intermediate/deep water.
  - Stream function (Rienecker & Fenton 1981 collocation, N = 10
    to 20 modes): fully nonlinear, the default for storm waves.

  Model 'auto' picks by steepness H/L, mirroring common practice:
    H/L < 0.01  -> Airy
    H/L < 0.03  -> Stokes (3rd-order evaluation)
    H/L < 0.06  -> Stokes 5th
    otherwise   -> stream function, N = clip(200 H/L, 10, 20)

  A uniform current U_c is added vectorially to the horizontal
  wave velocity along its own compass bearing. The current does
  not modify the wave solution itself (no Doppler shift of the
  dispersion relation) and does not contribute to fluid
  acceleration - both standard simplifications for quasi-static
  jacket checks.

  Kinematics above the instantaneous free surface are zero (no
  Wheeler stretching); evaluation heights for the nonlinear
  models are kept a centimetre inside the water column for
  numerical robustness, matching the behavior of the raschii
  library the reference tool wraps.

  BREAKING LIMITS (checked; reported as warnings, not errors):
    deep water:     H/L  < 0.142
    shallow water:  H/d  < 0.78
  Waves beyond these limits have no steady solution; the stream-
  function solver will also refuse to converge and says so.

4. HYDRODYNAMIC LOADING (MORISON EQUATION)
----------------------------------------------------------------
  Per unit length of each submerged member:

    f = 0.5 rho Cd D |U_perp| U_perp  +  rho Cm (pi D^2/4) A_perp

  where U_perp / A_perp are the water velocity / acceleration
  components perpendicular to the member axis (cross-flow
  principle). Each member is integrated with 15-point Gauss-
  Legendre quadrature; the resultant of each quadrature point is
  split to the member's end nodes by the lever rule (forces only,
  no fixed-end moments). Defaults Cd = 0.7, Cm = 2.0 are typical
  rough-cylinder storm values - set your own per design code.

  Assumptions/limits:
  - slender members (D/L < 0.2): diffraction neglected;
  - marine growth: the Wave tab's radial thickness is added to the
    HYDRODYNAMIC diameter (2t per member) for drag and inertia;
    it carries no structural stiffness or weight;
  - no member shielding or interference;
  - relative velocity ignored (structure assumed rigid vs flow).

5. STRUCTURAL MODEL
----------------------------------------------------------------
  3D Timoshenko beam elements, 12 DOF (3 translations + 3
  rotations per end node):
  - tubular sections from D (outer) and t: A, I, J = 2I, shear
    areas Ay = Az = 0.5 A (thin-wall approximation, valid for
    D/t > 10 - checked and warned);
  - 'leg' members use the Leg section; every other type
    (h_brace / x_brace / brace) uses the Brace section;
  - all joints are rigid (welded); supports are fully clamped
    (all 6 DOF) at the nodes marked Fixed;
  - linear elastic, small displacement.

  Loads applied in one static case:
  - Morison nodal forces (translations only);
  - topside interface loads spread equally over the Top nodes:
    axial as -Z, shear along the wave bearing, overturning and
    torsional moments split per node;
  - self-weight: 'calculated' lumps half of each member's weight
    to each end node; 'custom' spreads a total tonnage uniformly
    over ALL nodes; or excluded.

  The linear system is solved by Cholesky factorization of the
  free-DOF block (with a least-squares fallback if the structure
  is a mechanism); reactions come from R = K U - F at the fixed
  DOFs and always balance the applied loads - check the report's
  equilibrium lines.

6. STRESS CHECK
----------------------------------------------------------------
  For every member, the end forces at node 1 are converted to
  normal + bending + torsional + shear stresses at 8 points
  around the circumference (45 deg apart, at the outer radius),
  and the maximum von Mises stress is compared with fy:

    utilization = sigma_vm,max / fy

  Utilization > 100% is flagged. Note this is a YIELD screen
  only; API RP 2A-WSD member strength and simple-joint punching
  checks are available from the CLI (code-check, joint-check).

7. SCOPE OF THE GUI 'RUN' BUTTON vs THE FULL FRAMEWORK
----------------------------------------------------------------
  The GUI RUN button performs the quasi-static yield check
  (optionally on foundation springs - Loads tab). The CLI/API
  go well beyond the reference tool's scope:
  - global + member buckling (cli buckling), P-delta (cli pdelta)
  - fatigue: deterministic S-N screen and irregular-sea spectral
    screening with JONSWAP/PM realizations, narrow-band Rayleigh
    and rainflow damage (cli fatigue [--spectrum jonswap|pm])
  - soil-structure interaction: 6-DOF foundation springs on every
    analysis path (--support-spring), and pile-head springs derived
    from API p-y/t-z/Q-z soil curves (cli pile --from-analysis)
  - dynamics: natural frequencies (also Craig-Bampton reduced for
    refined meshes), steady-state wave-frequency response with a
    dynamic amplification factor, and transient Newmark time
    integration (regular waves, random seas, free decay)
  - code checks: API RP 2A-WSD member strength (cli code-check)
    and simple tubular-joint punching-shear (cli joint-check)
  - still-water buoyancy: sealed / free-flooding / legs-flooded
    member assumptions (Loads tab, cli --buoyancy)
  - appurtenances: risers/conductors/J-tubes as hydro-only
    members with Cd/Cm shielding factors (Members tab editor,
    JSON models, library API: add_appurtenances)
  - wave slamming: quasi-static splash-zone impact loads
    (DNV-RP-C205 form; cli --slam-cs, pointwise paths)
  - wind: API power-law profile member drag above still water
    plus a topside block force (cli --wind-speed --wind-area)
  - VIV susceptibility screening: member reduced velocity vs
    DNV onset values with stability-parameter gates (cli viv)
  - ISO 19902 member checks (partial-factor format) alongside
    the API RP 2A-WSD set (cli code-check --standard iso)
  Still outside scope everywhere: ringing,
  overlapping/stiffened joint checks.

8. WORKFLOW
----------------------------------------------------------------
  1) Geometry tab: load the default 3-leg jacket or enter nodes;
     mark supports (Fixed) and deck-interface nodes (Top). The
     live preview shows supports as red triangles, top nodes as
     blue squares, the MWL plane and a North arrow.
  2) Members tab: add members by node pair, or auto-generate legs
     (name pattern letter+level, e.g. A1-A2-A3) and horizontal
     ring braces per level.
  3) Material & Sections, Wave, Loads tabs: review defaults.
  4) Run Analysis: optional phase scan finds the wave phase with
     the largest total force; the FEM solve itself uses the
     entered analysis time t (matching the reference tool).
     Prefer the CLI 'refined'/'envelope' commands for full
     phase-resolved solves and multi-case design envelopes.
  5) Results tab: summary table, 3D utilization plot (green ->
     yellow -> red), CSV export of the member-force table.

  Model JSON save/load round-trips everything on these tabs.

9. DEFAULT STORM CASE (pre-filled)
----------------------------------------------------------------
  H = 17.038 m, T = 9.4 s, d = 50 m, U_c = 1.7 m/s, bearings 38
  deg, Cd = 0.7, Cm = 2.0; topside 25,100 kN axial + 2,900 kN
  shear; 1,100 t custom self-weight; leg 2000x75 mm, brace
  800x30 mm (D/t = 26.7), S355 steel.

10. REFERENCES
----------------------------------------------------------------
  - Fenton, J.D. (1985). "A fifth-order Stokes theory for steady
    waves." J. Waterway, Port, Coastal and Ocean Eng. 111(2).
  - Rienecker, M.M. & Fenton, J.D. (1981). "A Fourier
    approximation method for steady water waves." JFM 104.
  - Morison, O'Brien, Johnson & Schaaf (1950). "The force exerted
    by surface waves on piles." Petroleum Transactions 189.
  - Przemieniecki, J.S. (1968). Theory of Matrix Structural
    Analysis. (Timoshenko beam stiffness formulation.)
  - Craig, R.R. & Bampton, M.C.C. (1968). "Coupling of
    substructures for dynamic analyses." AIAA J. 6(7).
"""


# ---------------------------------------------------------------------------
# Headless core (display-independent).  The environment has no X server, so
# the GUI's logic — widget-string parsing and the whole RUN-button pipeline —
# lives in module functions the test suite drives directly; the Tk layer
# only collects strings and renders results (reference behavior:
# `JacketAnalysisGUI_v2.py:1827-1863` parses ~20 widget strings inline).
# ---------------------------------------------------------------------------

# The widget defaults as raw STRINGS — exactly what an untouched GUI's
# entries contain (the reference's canonical storm,
# `JacketAnalysisGUI_v2.py:1804-1822`).  The tab builders below insert
# these; the headless tests drive parse_params/run_analysis_core with them.
DEFAULT_RAW_PARAMS = dict(
    E="210000", nu="0.3", fy="355", rho_steel="7850", rho_water="1025",
    D_leg="2000", t_leg="75", D_brace="800", t_brace="30",
    H="17.038", T="9.4", d="50.0", Uc="1.7",
    wave_dir="38.0", current_dir="38.0", N="10", Cd="0.7", Cm="2.0",
    marine_growth="0", wave_model="auto",
    F_axial="25100", F_shear="2900", M_moment="0", M_torsion="0",
    custom_sw="1100", sw_mode="custom", buoyancy="none",
    wind_speed="0", wind_dir="38", wind_area="0",
    t_analysis="0.0",
)

PARAM_KEYS_FLOAT = (
    "E", "nu", "fy", "rho_steel", "rho_water",
    "D_leg", "t_leg", "D_brace", "t_brace",
    "H", "T", "d", "Uc", "wave_dir", "current_dir", "Cd", "Cm",
    "marine_growth",
    "F_axial", "F_shear", "M_moment", "M_torsion", "custom_sw",
    "wind_speed", "wind_dir", "wind_area", "t_analysis",
)
PARAM_KEYS_INT = ("N",)
PARAM_KEYS_STR = ("wave_model", "sw_mode", "buoyancy")


def parse_params(raw: dict) -> dict:
    """Typed parameter dict from raw widget STRINGS — the exact conversion
    the RUN button applies (float everywhere, ``int(float(.))`` for the
    harmonic count, verbatim strings for the mode selectors), as one
    headless-testable function.  Raises ValueError naming the offending
    field instead of a bare float() traceback."""
    p = {}
    for k in PARAM_KEYS_FLOAT + PARAM_KEYS_INT + PARAM_KEYS_STR:
        if k not in raw:
            raise ValueError(f"missing parameter: {k}")
        v = raw[k]
        try:
            if k in PARAM_KEYS_STR:
                p[k] = str(v)
            elif k in PARAM_KEYS_INT:
                p[k] = int(float(v))
            else:
                p[k] = float(v)
        except (TypeError, ValueError):
            raise ValueError(f"invalid value for {k}: {v!r}") from None
    return p


def build_model_from_data(p: dict, nodes_data, members_data, fixed_nodes,
                          top_nodes, apps_data=()):
    """The GUI's model construction from its plain-data state (dicts and
    lists — no widgets)."""
    from .models.model import add_appurtenances, build_model
    model = build_model(nodes_data, members_data, fixed_nodes, top_nodes,
                        leg_section=(p["D_leg"], p["t_leg"]),
                        brace_section=(p["D_brace"], p["t_brace"]),
                        rho_steel=p["rho_steel"])
    return add_appurtenances(model, apps_data)


def run_analysis_core(p: dict, nodes_data, members_data, fixed_nodes,
                      top_nodes, apps_data=(), do_phase_scan: bool = True,
                      springs=None, log=lambda msg: None) -> dict:
    """The full RUN-ANALYSIS pipeline on plain data: validate, build model
    and wave, optional 36-step phase scan, solve (foundation springs
    optional), render the report.  Returns a dict with model / wave /
    case / res / scan / report / util.  This is everything
    ``JacketGUI.run_analysis`` does between reading the widgets and
    painting the log pane."""
    import jax
    jax.config.update("jax_enable_x64", True)
    from . import (LoadCase, analyze, analyze_ssi, make_wave,
                   validate_wave)
    from .utils.report import render_report

    if p["marine_growth"] < 0:
        raise ValueError("marine growth thickness must be >= 0 mm")
    for msg in validate_wave(p["H"], p["T"], p["d"]):
        log(f"WARNING: {msg}")
    model = build_model_from_data(p, nodes_data, members_data, fixed_nodes,
                                  top_nodes, apps_data)
    log(f"Building wave model ({p['wave_model']})...")
    wave = make_wave(p["H"], p["T"], p["d"], p["Uc"],
                     model=p["wave_model"], N=p["N"])
    case = LoadCase(
        E=p["E"], nu=p["nu"], fy=p["fy"], rho_water=p["rho_water"],
        wave_dir_deg=p["wave_dir"], current_dir_deg=p["current_dir"],
        Cd=p["Cd"], Cm=p["Cm"], F_axial_kN=p["F_axial"],
        F_shear_kN=p["F_shear"], M_moment_kNm=p["M_moment"],
        M_torsion_kNm=p["M_torsion"], custom_sw_tonnes=p["custom_sw"],
        t_analysis=p["t_analysis"], sw_mode=p["sw_mode"],
        buoyancy=p["buoyancy"],
        wind_speed_ms=p["wind_speed"], wind_dir_deg=p["wind_dir"],
        wind_topside_area_m2=p["wind_area"],
        marine_growth_mm=p["marine_growth"])

    scan = None
    if do_phase_scan:
        log("Scanning wave period for critical phase...")
        from .ops.morison import hydro_members
        from . import phase_scan as _scan
        conn_h, D_m, Cd_h, Cm_h = hydro_members(
            model, case.marine_growth_mm, case.Cd, case.Cm)
        scan = _scan(wave, model.coords, conn_h, D_m,
                     case.wave_dir_deg, case.current_dir_deg,
                     Cd_h, Cm_h, case.rho_water, n_steps=36)

    log("Solving (first run compiles the XLA program)...")
    if springs is not None:
        log(f"[foundation] supports on 6-DOF springs k = {springs} "
            f"(N/mm, N*mm/rad)")
        res = analyze_ssi(model, wave, case, springs)
    else:
        res = analyze(model, wave, case, solver="chol")
    report = render_report(model, wave, case, res, phase_scan=scan)
    log(report)
    return dict(model=model, wave=wave, case=case, res=res, scan=scan,
                report=report,
                util=float(np.asarray(res.utilization).max()))


class JacketGUI:
    def __init__(self, root):
        self.root = root
        root.title("JAX Jacket Structural Analysis")
        root.geometry("1500x950")

        self.nodes_data: dict[str, list] = {}
        self.members_data: list[dict] = []
        self.apps_data: list[dict] = []     # hydro-only appurtenances
        self.fixed_nodes: list[str] = []
        self.top_nodes: list[str] = []
        self.analysis_results = None
        self.analysis_model = None

        nb = ttk.Notebook(root)
        nb.pack(fill=tk.BOTH, expand=True, padx=5, pady=5)
        self.tabs = {}
        for name in ["1. Node Geometry", "2. Members", "3. Material & Sections",
                     "4. Wave Parameters", "5. Loads", "6. Run Analysis",
                     "7. Results", "8. Info & Assumptions"]:
            f = ttk.Frame(nb)
            nb.add(f, text=name)
            self.tabs[name] = f

        self._build_geometry_tab()
        self._build_members_tab()
        self._build_material_tab()
        self._build_wave_tab()
        self._build_loads_tab()
        self._build_analysis_tab()
        self._build_results_tab()
        self._build_info_tab()

        self.load_default_geometry()
        self.load_default_params()

    # ------------------------------------------------------------- geometry
    def _build_geometry_tab(self):
        f = self.tabs["1. Node Geometry"]
        left = ttk.Frame(f)
        left.pack(side=tk.LEFT, fill=tk.BOTH, expand=True)
        right = ttk.Frame(f)
        right.pack(side=tk.RIGHT, fill=tk.BOTH, expand=True)

        entry = ttk.Frame(left)
        entry.pack(fill=tk.X, padx=5, pady=5)
        self.node_entries = {}
        for col, key in enumerate(["Name", "X", "Y", "Z"]):
            ttk.Label(entry, text=key + ":").grid(row=0, column=2 * col)
            e = ttk.Entry(entry, width=10)
            e.grid(row=0, column=2 * col + 1, padx=2)
            self.node_entries[key.lower()] = e
        ttk.Button(entry, text="Add Node", command=self.add_node).grid(
            row=0, column=8, padx=4)
        ttk.Button(entry, text="Delete Selected",
                   command=self.delete_node).grid(row=0, column=9, padx=4)

        cols = ("name", "x", "y", "z", "fixed", "top")
        self.node_tree = ttk.Treeview(left, columns=cols, show="headings",
                                      height=18)
        for c in cols:
            self.node_tree.heading(c, text=c.upper())
            self.node_tree.column(c, width=90)
        self.node_tree.pack(fill=tk.BOTH, expand=True, padx=5, pady=5)

        btns = ttk.Frame(left)
        btns.pack(fill=tk.X, padx=5, pady=5)
        for text, cmd in [("Toggle Fixed (Support)", self.toggle_fixed),
                          ("Toggle Top (Interface)", self.toggle_top),
                          ("Load Default Geometry", self.load_default_geometry),
                          ("Clear All", self.clear_geometry),
                          ("Refresh 3D Preview", self.update_3d_preview),
                          ("Save Model JSON...", self.save_model_json),
                          ("Load Model JSON...", self.load_model_json)]:
            ttk.Button(btns, text=text, command=cmd).pack(side=tk.LEFT, padx=4)

        # ---- embedded live 3D preview with water plane + compass arrows,
        # like the reference's geometry-tab canvas
        # (`JacketAnalysisGUI_v2.py:1038-1135`); redrawn on every
        # geometry change ----
        try:
            import matplotlib
            matplotlib.use("TkAgg")
            from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg
            from matplotlib.figure import Figure
            self._preview_fig = Figure(figsize=(6.2, 6.2), dpi=90)
            self._preview_ax = self._preview_fig.add_subplot(
                111, projection="3d")
            self._preview_canvas = FigureCanvasTkAgg(self._preview_fig,
                                                     master=right)
            self._preview_canvas.get_tk_widget().pack(fill=tk.BOTH,
                                                      expand=True,
                                                      padx=5, pady=5)
        except Exception:          # no usable backend: keep CRUD usable
            self._preview_canvas = None

    def update_3d_preview(self):
        """Redraw the embedded geometry preview from the current tables."""
        if getattr(self, "_preview_canvas", None) is None:
            return
        ax = self._preview_ax
        ax.clear()
        if self.nodes_data:
            from .utils.plotting import _draw_structure
            try:
                model = self._build_model()
            except Exception:
                return              # half-edited geometry: keep the old view
            _draw_structure(ax, model)
            ax.set_title(f"{model.n_nodes} nodes / {model.n_members} members")
        self._preview_canvas.draw_idle()

    def add_node(self):
        name = self.node_entries["name"].get().strip().upper()
        try:
            xyz = [float(self.node_entries[k].get()) for k in "xyz"]
        except ValueError:
            messagebox.showerror("Error", "Invalid coordinate values")
            return
        if not name:
            messagebox.showerror("Error", "Node name cannot be empty")
            return
        self.nodes_data[name] = xyz
        self.refresh_nodes()

    def delete_node(self):
        for item in self.node_tree.selection():
            name = self.node_tree.item(item)["values"][0]
            self.nodes_data.pop(name, None)
            for lst in (self.fixed_nodes, self.top_nodes):
                if name in lst:
                    lst.remove(name)
        self.refresh_nodes()

    def _toggle(self, lst):
        for item in self.node_tree.selection():
            name = self.node_tree.item(item)["values"][0]
            if name in lst:
                lst.remove(name)
            else:
                lst.append(name)
        self.refresh_nodes()

    def toggle_fixed(self):
        self._toggle(self.fixed_nodes)

    def toggle_top(self):
        self._toggle(self.top_nodes)

    def refresh_nodes(self):
        self.node_tree.delete(*self.node_tree.get_children())
        for name, c in sorted(self.nodes_data.items()):
            self.node_tree.insert("", tk.END, values=(
                name, f"{c[0]:.3f}", f"{c[1]:.3f}", f"{c[2]:.3f}",
                "x" if name in self.fixed_nodes else "",
                "x" if name in self.top_nodes else ""))
        self.update_3d_preview()

    def clear_geometry(self):
        if messagebox.askyesno("Confirm", "Clear all geometry data?"):
            self.nodes_data, self.members_data = {}, []
            self.apps_data = []
            self.fixed_nodes, self.top_nodes = [], []
            self.refresh_nodes()
            self.refresh_members()
            self.refresh_appurtenances()

    def load_default_geometry(self):
        from .models.presets import default_3leg_jacket_geometry
        nodes, members, fixed, top = default_3leg_jacket_geometry(47.0)
        self.nodes_data = {k: list(v) for k, v in nodes.items()}
        self.members_data = list(members)
        self.fixed_nodes, self.top_nodes = list(fixed), list(top)
        self.refresh_nodes()
        self.refresh_members()

    def save_model_json(self):
        path = filedialog.asksaveasfilename(defaultextension=".json")
        if path:
            from .utils.io import save_model
            save_model(path, self._build_model(), params=self._params())
            messagebox.showinfo("Saved", f"Model written to {path}")

    def load_model_json(self):
        path = filedialog.askopenfilename(filetypes=[("JSON", "*.json")])
        if not path:
            return
        import json
        d = json.loads(open(path).read())
        self.nodes_data = {k: list(v) for k, v in d["nodes"].items()}
        self.members_data = d["members"]
        self.apps_data = d.get("appurtenances", [])
        self.fixed_nodes = d.get("fixed_nodes", [])
        self.top_nodes = d.get("top_nodes", [])
        self.refresh_nodes()
        self.refresh_members()
        self.refresh_appurtenances()

    # -------------------------------------------------------------- members
    def _build_members_tab(self):
        f = self.tabs["2. Members"]
        entry = ttk.Frame(f)
        entry.pack(fill=tk.X, padx=5, pady=5)
        self.member_entries = {}
        for col, key in enumerate(["Name", "Node 1", "Node 2"]):
            ttk.Label(entry, text=key + ":").grid(row=0, column=2 * col)
            e = ttk.Entry(entry, width=12)
            e.grid(row=0, column=2 * col + 1, padx=2)
            self.member_entries[key.lower().replace(" ", "")] = e
        ttk.Label(entry, text="Type:").grid(row=0, column=6)
        self.member_type = tk.StringVar(value="brace")
        ttk.Combobox(entry, textvariable=self.member_type, width=9,
                     values=["leg", "h_brace", "x_brace", "brace"]).grid(
            row=0, column=7, padx=2)
        ttk.Label(entry, text="Ends:").grid(row=0, column=8)
        self.member_release = tk.StringVar(value="none")
        ttk.Combobox(entry, textvariable=self.member_release, width=8,
                     values=["none", "pinned1", "pinned2", "pinned"]).grid(
            row=0, column=9, padx=2)
        ttk.Button(entry, text="Add Member", command=self.add_member).grid(
            row=0, column=10, padx=4)
        ttk.Button(entry, text="Delete Selected",
                   command=self.delete_member).grid(row=0, column=11, padx=4)

        cols = ("name", "node1", "node2", "type", "release")
        self.member_tree = ttk.Treeview(f, columns=cols, show="headings",
                                        height=20)
        for c in cols:
            self.member_tree.heading(c, text=c.upper())
            self.member_tree.column(c, width=150)
        self.member_tree.pack(fill=tk.BOTH, expand=True, padx=5, pady=5)

        btns = ttk.Frame(f)
        btns.pack(fill=tk.X, padx=5, pady=5)
        ttk.Label(btns, text="Auto-generate:").pack(side=tk.LEFT, padx=4)
        ttk.Button(btns, text="Legs (A1-A2-A3...)",
                   command=self.autogen_legs).pack(side=tk.LEFT, padx=4)
        ttk.Button(btns, text="Horizontal Braces",
                   command=self.autogen_h).pack(side=tk.LEFT, padx=4)

        # --- appurtenances: hydro-only risers/conductors (beyond the
        # reference, whose Info tab excludes them) ---
        appf = ttk.LabelFrame(
            f, text="Appurtenances (risers/conductors — attract wave load, "
                    "no stiffness/weight)")
        appf.pack(fill=tk.X, padx=5, pady=5)
        row = ttk.Frame(appf)
        row.pack(fill=tk.X, padx=3, pady=3)
        self.app_entries = {}
        for col, (label, key, width, default) in enumerate(
                [("Name", "name", 10, ""), ("Node 1", "node1", 8, ""),
                 ("Node 2", "node2", 8, ""), ("D [mm]", "D_mm", 8, "610"),
                 ("Cd mult", "cd_mult", 7, "1.0"),
                 ("Cm mult", "cm_mult", 7, "1.0")]):
            ttk.Label(row, text=label + ":").grid(row=0, column=2 * col)
            e = ttk.Entry(row, width=width)
            if default:
                e.insert(0, default)
            e.grid(row=0, column=2 * col + 1, padx=2)
            self.app_entries[key] = e
        ttk.Button(row, text="Add", command=self.add_appurtenance).grid(
            row=0, column=12, padx=4)
        ttk.Button(row, text="Delete Selected",
                   command=self.delete_appurtenance).grid(row=0, column=13,
                                                          padx=4)
        acols = ("name", "node1", "node2", "D_mm", "cd_mult", "cm_mult")
        self.app_tree = ttk.Treeview(appf, columns=acols, show="headings",
                                     height=4)
        for c in acols:
            self.app_tree.heading(c, text=c.upper())
            self.app_tree.column(c, width=100)
        self.app_tree.pack(fill=tk.X, padx=3, pady=3)

    def add_member(self):
        name = self.member_entries["name"].get().strip()
        n1 = self.member_entries["node1"].get().strip().upper()
        n2 = self.member_entries["node2"].get().strip().upper()
        if not all([name, n1, n2]):
            messagebox.showerror("Error", "All fields are required")
            return
        if n1 not in self.nodes_data or n2 not in self.nodes_data:
            messagebox.showerror("Error", f"Nodes {n1} or {n2} not defined")
            return
        m = {"name": name, "node1": n1, "node2": n2,
             "type": self.member_type.get()}
        if self.member_release.get() not in ("", "none"):
            m["release"] = self.member_release.get()
        self.members_data.append(m)
        self.refresh_members()

    def delete_member(self):
        names = {self.member_tree.item(i)["values"][0]
                 for i in self.member_tree.selection()}
        self.members_data = [m for m in self.members_data
                             if m["name"] not in names]
        self.refresh_members()

    def refresh_members(self):
        self.member_tree.delete(*self.member_tree.get_children())
        for m in self.members_data:
            self.member_tree.insert("", tk.END, values=(
                m["name"], m["node1"], m["node2"], m["type"],
                m.get("release", "none")))
        self.update_3d_preview()

    def add_appurtenance(self):
        g = {k: e.get().strip() for k, e in self.app_entries.items()}
        if not all([g["name"], g["node1"], g["node2"], g["D_mm"]]):
            messagebox.showerror("Error", "All fields are required")
            return
        n1, n2 = g["node1"].upper(), g["node2"].upper()
        if n1 not in self.nodes_data or n2 not in self.nodes_data:
            messagebox.showerror("Error", f"Nodes {n1} or {n2} not defined")
            return
        try:
            spec = {"name": g["name"], "node1": n1, "node2": n2,
                    "D_mm": float(g["D_mm"]),
                    "cd_mult": float(g["cd_mult"] or 1.0),
                    "cm_mult": float(g["cm_mult"] or 1.0)}
            if spec["D_mm"] <= 0 or spec["cd_mult"] < 0 or spec["cm_mult"] < 0:
                raise ValueError
        except ValueError:
            messagebox.showerror("Error", "D must be > 0 and the Cd/Cm "
                                          "multipliers >= 0")
            return
        self.apps_data.append(spec)
        self.refresh_appurtenances()

    def delete_appurtenance(self):
        names = {self.app_tree.item(i)["values"][0]
                 for i in self.app_tree.selection()}
        self.apps_data = [a for a in self.apps_data
                          if a["name"] not in names]
        self.refresh_appurtenances()

    def refresh_appurtenances(self):
        self.app_tree.delete(*self.app_tree.get_children())
        for a in self.apps_data:
            self.app_tree.insert("", tk.END, values=(
                a["name"], a["node1"], a["node2"], a["D_mm"],
                a["cd_mult"], a["cm_mult"]))
        self.update_3d_preview()

    def autogen_legs(self):
        from .models.autogen import auto_generate_legs
        auto_generate_legs(self.nodes_data, self.members_data)
        self.refresh_members()

    def autogen_h(self):
        from .models.autogen import auto_generate_h_braces
        auto_generate_h_braces(self.nodes_data, self.members_data)
        self.refresh_members()

    # ---------------------------------------------- material / wave / loads
    def _entry_grid(self, frame, rows):
        entries = {}
        for r, (label, key, default, unit) in enumerate(rows):
            ttk.Label(frame, text=label).grid(row=r, column=0, sticky="e",
                                              padx=5, pady=2)
            e = ttk.Entry(frame, width=12)
            e.insert(0, default)
            e.grid(row=r, column=1, padx=5)
            ttk.Label(frame, text=unit).grid(row=r, column=2, sticky="w")
            entries[key] = e
        return entries

    def _build_material_tab(self):
        f = ttk.Frame(self.tabs["3. Material & Sections"], padding=10)
        f.pack(fill=tk.BOTH)
        self.mat = self._entry_grid(f, [
            ("Young's Modulus (E):", "E", "210000", "N/mm2 (MPa)"),
            ("Poisson's Ratio (nu):", "nu", "0.3", ""),
            ("Yield Strength (fy):", "fy", "355", "MPa"),
            ("Steel Density:", "rho_steel", "7850", "kg/m3"),
            ("Water Density:", "rho_water", "1025", "kg/m3"),
            ("Leg D:", "D_leg", "2000", "mm"),
            ("Leg t:", "t_leg", "75", "mm"),
            ("Brace D:", "D_brace", "800", "mm"),
            ("Brace t:", "t_brace", "30", "mm"),
        ])

    def _build_wave_tab(self):
        f = ttk.Frame(self.tabs["4. Wave Parameters"], padding=10)
        f.pack(fill=tk.BOTH)
        self.wav = self._entry_grid(f, [
            ("Wave Height (H):", "H", "17.038", "m"),
            ("Period (T):", "T", "9.4", "s"),
            ("Water Depth (d):", "d", "50.0", "m"),
            ("Current Speed (Uc):", "Uc", "1.7", "m/s"),
            ("Wave Direction:", "wave_dir", "38.0", "deg from North (cw)"),
            ("Current Direction:", "current_dir", "38.0", "deg from North (cw)"),
            ("Harmonics (N):", "N", "10", ""),
            ("Drag Coeff (Cd):", "Cd", "0.7", ""),
            ("Inertia Coeff (Cm):", "Cm", "2.0", ""),
            ("Marine Growth:", "marine_growth", "0", "mm (radial, hydro D only)"),
        ])
        ttk.Label(f, text="Wave Model:").grid(row=10, column=0, sticky="e",
                                              padx=5)
        self.wave_model = tk.StringVar(value="auto")
        ttk.Combobox(f, textvariable=self.wave_model, width=10,
                     values=["auto", "fenton", "stokes", "airy"]).grid(
            row=10, column=1)
        self.do_phase_scan = tk.BooleanVar(value=True)
        ttk.Checkbutton(f, text="Scan wave period for critical phase",
                        variable=self.do_phase_scan).grid(
            row=11, column=0, columnspan=2, pady=4)

    def _build_loads_tab(self):
        f = ttk.Frame(self.tabs["5. Loads"], padding=10)
        f.pack(fill=tk.BOTH)
        self.lds = self._entry_grid(f, [
            ("Topside Axial:", "F_axial", "25100", "kN (compression)"),
            ("Topside Shear:", "F_shear", "2900", "kN (along wave dir)"),
            ("Overturning Moment:", "M_moment", "0", "kNm"),
            ("Torsional Moment:", "M_torsion", "0", "kNm"),
            ("Custom Self-weight:", "custom_sw", "1100", "tonnes"),
        ])
        self.sw_mode = tk.StringVar(value="custom")
        for r, (label, val) in enumerate([
                ("Calculated from member masses", "calculated"),
                ("Custom total (tonnes above)", "custom"),
                ("Exclude self-weight", "none")]):
            ttk.Radiobutton(f, text=label, variable=self.sw_mode,
                            value=val).grid(row=5 + r, column=0, columnspan=2,
                                            sticky="w")
        # still-water buoyancy (beyond the reference, which lists
        # flooded-member effects as excluded in its Info tab)
        bf = ttk.Frame(f)
        bf.grid(row=8, column=0, columnspan=3, sticky="w", pady=(10, 0))
        ttk.Label(bf, text="Buoyancy:").pack(side=tk.LEFT)
        self.buoyancy = tk.StringVar(value="none")
        ttk.Combobox(bf, textvariable=self.buoyancy, width=14,
                     state="readonly",
                     values=["none", "sealed", "flooded",
                             "legs-flooded"]).pack(side=tk.LEFT, padx=4)
        ttk.Label(bf, text="(still-water uplift on wetted members)").pack(
            side=tk.LEFT)
        # foundation springs (soil-structure interaction; beyond the
        # reference, which clamps the supports rigidly and lists SSI as
        # excluded in its Info tab)
        self.use_springs = tk.BooleanVar(value=False)
        ttk.Checkbutton(
            f, text="Supports on foundation springs (kx ky kz [N/mm], "
                    "krx kry krz [N*mm/rad]):",
            variable=self.use_springs).grid(row=9, column=0, columnspan=3,
                                            sticky="w", pady=(10, 0))
        sp = ttk.Frame(f)
        sp.grid(row=10, column=0, columnspan=3, sticky="w")
        self.spring_entries = []
        for default in ["1e6", "1e6", "1e6", "1e12", "1e12", "1e12"]:
            e = ttk.Entry(sp, width=8)
            e.insert(0, default)
            e.pack(side=tk.LEFT, padx=2)
            self.spring_entries.append(e)
        # wind (beyond the reference: it only takes the hand-typed topside
        # shear above).  0 m/s = off.
        wf = ttk.Frame(f)
        wf.grid(row=11, column=0, columnspan=3, sticky="w", pady=(10, 0))
        ttk.Label(wf, text="Wind (API profile):").pack(side=tk.LEFT)
        self.wind_entries = {}
        for label, key, default, width in [
                ("speed @10m [m/s]", "wind_speed", "0", 6),
                ("dir [deg N]", "wind_dir", "38", 6),
                ("topside area [m^2]", "wind_area", "0", 7)]:
            ttk.Label(wf, text="  " + label + ":").pack(side=tk.LEFT)
            e = ttk.Entry(wf, width=width)
            e.insert(0, default)
            e.pack(side=tk.LEFT, padx=2)
            self.wind_entries[key] = e

    # ------------------------------------------------------------- analysis
    def _build_analysis_tab(self):
        f = self.tabs["6. Run Analysis"]
        top = ttk.Frame(f, padding=5)
        top.pack(fill=tk.X)
        ttk.Label(top, text="Analysis time t:").pack(side=tk.LEFT)
        self.entry_t = ttk.Entry(top, width=8)
        self.entry_t.insert(0, "0.0")
        self.entry_t.pack(side=tk.LEFT, padx=4)
        ttk.Label(top, text="s").pack(side=tk.LEFT)
        ttk.Button(top, text="RUN ANALYSIS",
                   command=self.run_analysis).pack(side=tk.LEFT, padx=20)
        self.log_text = tk.Text(f, font=("Consolas", 9))
        self.log_text.pack(fill=tk.BOTH, expand=True, padx=5, pady=5)

    def log(self, msg):
        self.log_text.insert(tk.END, msg + "\n")
        self.log_text.see(tk.END)
        self.root.update()

    def _raw_params(self) -> dict:
        """Raw widget STRINGS keyed for :func:`parse_params`."""
        raw = {k: e.get() for k, e in self.mat.items()}
        raw.update({k: e.get() for k, e in self.wav.items()})
        raw.update({k: e.get() for k, e in self.lds.items()})
        raw.update({k: e.get() for k, e in self.wind_entries.items()})
        raw.update(wave_model=self.wave_model.get(),
                   sw_mode=self.sw_mode.get(),
                   buoyancy=self.buoyancy.get(),
                   t_analysis=self.entry_t.get())
        return raw

    def _params(self) -> dict:
        return parse_params(self._raw_params())

    def _build_model(self, p=None):
        p = p or self._params()
        return build_model_from_data(p, self.nodes_data, self.members_data,
                                     self.fixed_nodes, self.top_nodes,
                                     self.apps_data)

    def run_analysis(self):
        self.log_text.delete("1.0", tk.END)
        try:
            p = self._params()
            springs = ([float(e.get()) for e in self.spring_entries]
                       if self.use_springs.get() else None)
            out = run_analysis_core(
                p, self.nodes_data, self.members_data, self.fixed_nodes,
                self.top_nodes, self.apps_data,
                do_phase_scan=self.do_phase_scan.get(), springs=springs,
                log=self.log)
            self.analysis_results = out["res"]
            self.analysis_model = out["model"]
            self.analysis_case = out["case"]
            self.analysis_wave = out["wave"]
            self.analysis_scan = out["scan"]
            messagebox.showinfo(
                "Complete",
                f"Analysis complete!\n\n"
                f"Wave model: {out['wave'].model_info()}\n"
                f"Max utilization: {out['util']:.2%}")
        except Exception as e:
            import traceback
            self.log(f"\nERROR: {e}")
            self.log(traceback.format_exc())
            messagebox.showerror("Error", str(e))

    # -------------------------------------------------------------- results
    def _build_results_tab(self):
        f = self.tabs["7. Results"]
        btns = ttk.Frame(f, padding=5)
        btns.pack(fill=tk.X)
        ttk.Button(btns, text="Show Summary",
                   command=self.show_summary).pack(side=tk.LEFT, padx=4)
        ttk.Button(btns, text="3D Utilization Plot",
                   command=self.plot_results).pack(side=tk.LEFT, padx=4)
        ttk.Button(btns, text="Phase Scan Plot",
                   command=self.plot_phase_scan).pack(side=tk.LEFT, padx=4)
        ttk.Button(btns, text="Code Checks",
                   command=self.show_code_checks).pack(side=tk.LEFT, padx=4)
        ttk.Button(btns, text="Damage Screen",
                   command=self.show_damage_screen).pack(side=tk.LEFT,
                                                         padx=4)
        ttk.Button(btns, text="Spectral Fatigue",
                   command=self.show_spectral_fatigue).pack(side=tk.LEFT,
                                                            padx=4)
        ttk.Button(btns, text="Export CSV...",
                   command=self.export_csv).pack(side=tk.LEFT, padx=4)
        self.results_text = tk.Text(f, font=("Consolas", 9))
        self.results_text.pack(fill=tk.BOTH, expand=True, padx=5, pady=5)

    def show_summary(self):
        if self.analysis_results is None:
            messagebox.showwarning("Warning", "Run analysis first!")
            return
        from .utils.io import member_force_table
        self.results_text.delete("1.0", tk.END)
        for m in member_force_table(self.analysis_model,
                                    self.analysis_results):
            self.results_text.insert(tk.END, (
                f"{m['member']}: Fx={m['Fx_max_kN']:.1f}kN, "
                f"VM={m['von_mises_max_MPa']:.1f}MPa, "
                f"Util={m['utilization']:.2%}\n"))

    def show_code_checks(self):
        if self.analysis_results is None:
            messagebox.showwarning("Warning", "Run analysis first!")
            return
        from .utils.report import render_code_checks
        self.results_text.delete("1.0", tk.END)
        try:
            txt = render_code_checks(self.analysis_model,
                                     self.analysis_results,
                                     Fy=float(self.analysis_case.fy))
        except Exception as e:
            messagebox.showerror("Error", str(e))
            return
        self.results_text.insert(tk.END, txt + "\n")

    def show_damage_screen(self):
        """ALS single-member-removal screen on the last analysis state
        (beyond the reference: its Info tab leaves redundancy unassessed)."""
        if self.analysis_results is None:
            messagebox.showwarning("Warning", "Run analysis first!")
            return
        from .ops.robustness import member_removal_screen
        self.results_text.delete("1.0", tk.END)
        try:
            scr = member_removal_screen(self.analysis_model,
                                        self.analysis_wave,
                                        self.analysis_case)
        except Exception as e:
            messagebox.showerror("Error", str(e))
            return
        util = np.asarray(scr.max_util)
        stable = np.asarray(scr.stable)
        crit = np.asarray(scr.critical)
        gov = np.asarray(scr.governing_member)
        names = self.analysis_model.member_names
        self.results_text.insert(tk.END, (
            "SINGLE-MEMBER-REMOVAL (ALS DAMAGE) SCREEN\n"
            f"intact max utilization: {float(scr.intact_util):.2%}\n"
            f"critical members: {int(crit.sum())}\n\n"
            f"{'Removed':<26}{'max util (others)':>20}{'governing':>22}\n"))
        order = np.argsort(np.where(stable, util, np.inf))[::-1]
        for m in order[:20]:
            state = "UNSTABLE" if not stable[m] else f"{util[m]:.2%}"
            flag = "  << CRITICAL" if crit[m] else ""
            self.results_text.insert(tk.END, (
                f"{names[m]:<26}{state:>20}{names[int(gov[m])]:>22}{flag}\n"))

    def show_spectral_fatigue(self):
        """Frequency-domain fatigue screen of the sea state BEHIND the
        design wave (beyond the reference: one deterministic wave is all
        it can express).  The design wave height maps to Hs = H / 1.86
        (the customary extreme-wave ratio), Tp = T; 25-year exposure on
        the D-seawater-CP curve with SCF 1.5, closed-form Wirsching-Light
        damage — no time march."""
        if self.analysis_results is None:
            messagebox.showwarning("Warning", "Run analysis first!")
            return
        from .api import (prepare_condensed, spectral_response_prepared)
        from .models.model import refine_model
        from .ops.spectrum import make_random_sea
        self.results_text.delete("1.0", tk.END)
        try:
            model = self.analysis_model
            wave, case = self.analysis_wave, self.analysis_case
            Hs = float(np.asarray(wave.H)) / 1.86
            Tp = float(np.asarray(wave.T))
            sea = make_random_sea(Hs, Tp, float(np.asarray(wave.d)),
                                  n_components=32,
                                  U_c=float(np.asarray(wave.U_c)),
                                  dtype=model.coords.dtype)
            refined = refine_model(model, 2)
            prep = prepare_condensed(model, refined, 2, E=float(case.E),
                                     nu=float(case.nu))
            res = spectral_response_prepared(prep, sea, case,
                                             exposure_years=25.0,
                                             curve="D-sea-cp", scf=1.5)
        except Exception as e:
            messagebox.showerror("Error", str(e))
            return
        sig = np.asarray(res.sigma_stress)
        dwl = np.asarray(res.damage_wl)
        life = np.asarray(res.life_years_wl)
        names = refined.member_names
        self.results_text.insert(tk.END, (
            "FREQUENCY-DOMAIN SPECTRAL FATIGUE SCREEN\n"
            f"JONSWAP Hs={Hs:.2f} m (design H/1.86), Tp={Tp:.1f} s, "
            "32 components; 25 y exposure, curve D-sea-cp, SCF 1.5\n"
            f"sigma displacement {float(res.sigma_disp_mm):.1f} mm, "
            f"3-h MPM {float(res.mpm_disp_mm):.1f} mm\n\n"
            f"{'Member':<26}{'sigma MPa':>10}{'D (W-L)':>12}"
            f"{'Life [y]':>10}\n"))
        for e in np.argsort(dwl)[::-1][:20]:
            lf = f"{life[e]:.0f}" if np.isfinite(life[e]) else "inf"
            self.results_text.insert(tk.END, (
                f"{names[e]:<26}{sig[e]:>10.1f}{dwl[e]:>12.3e}{lf:>10}\n"))
        if dwl.max() > 1.0:
            self.results_text.insert(
                tk.END, "\nWARNING: Miner damage > 1 under this sea state "
                        "climate assumption!\n")

    def plot_results(self):
        if self.analysis_results is None:
            messagebox.showwarning("Warning", "Run analysis first!")
            return
        import matplotlib
        matplotlib.use("TkAgg")
        import matplotlib.pyplot as plt
        from .utils.plotting import _draw_structure, _util_color
        util = np.asarray(self.analysis_results.utilization)
        fig = plt.figure(figsize=(11, 10))
        ax = fig.add_subplot(111, projection="3d")
        _draw_structure(ax, self.analysis_model,
                        member_colors=[_util_color(u) for u in util])
        ax.set_title(f"Max utilization {util.max():.1%}")
        plt.show()

    def plot_phase_scan(self):
        scan = getattr(self, "analysis_scan", None)
        if scan is None:
            messagebox.showwarning(
                "Warning", "Run an analysis with the phase-scan option "
                "checked first!")
            return
        import matplotlib
        matplotlib.use("TkAgg")
        import matplotlib.pyplot as plt
        t = np.asarray(scan.t)
        fig, ax = plt.subplots(figsize=(9, 5))
        ax.plot(t, np.asarray(scan.total_kN), label="total", lw=2)
        ax.plot(t, np.asarray(scan.drag_kN), label="drag", ls="--")
        ax.plot(t, np.asarray(scan.inertia_kN), label="inertia", ls=":")
        ci = int(scan.critical_index)
        ax.axvline(t[ci], color="red", alpha=0.5,
                   label=f"critical t={t[ci]:.2f}s")
        ax.set_xlabel("t [s]")
        ax.set_ylabel("|F| [kN]")
        ax.set_title("Morison force over one wave period")
        ax.legend()
        ax.grid(alpha=0.3)
        plt.show()

    def export_csv(self):
        if self.analysis_results is None:
            messagebox.showwarning("Warning", "Run analysis first!")
            return
        path = filedialog.asksaveasfilename(defaultextension=".csv",
                                            filetypes=[("CSV", "*.csv")])
        if path:
            from .utils.io import export_csv
            export_csv(path, self.analysis_model, self.analysis_results)
            messagebox.showinfo("Exported", f"Saved to {path}")

    # ----------------------------------------------------------------- info
    def _build_info_tab(self):
        t = tk.Text(self.tabs["8. Info & Assumptions"], font=("Consolas", 9))
        t.insert("1.0", INFO_TEXT)
        t.configure(state="disabled")
        t.pack(fill=tk.BOTH, expand=True, padx=5, pady=5)

    def load_default_params(self):
        pass  # defaults are pre-filled in the entry constructors


def main():
    root = tk.Tk()
    root.update_idletasks()
    w, h = 1500, 950
    x = (root.winfo_screenwidth() - w) // 2
    y = (root.winfo_screenheight() - h) // 2
    root.geometry(f"{w}x{h}+{x}+{y}")
    JacketGUI(root)
    root.mainloop()


if __name__ == "__main__":
    main()
