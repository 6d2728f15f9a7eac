"""Worked example 12: frequency-domain stochastic response and
long-term spectral fatigue.

The whole stochastic analysis happens without a single time step:
Borgman-linearizing the Morison drag makes each spectral component's
load linear in its amplitude, so 2N+1 condensed multi-RHS solves (the
mean row + N cosine/sine transfer rows) characterize the full response
process.  Closed forms then give stress std devs, most-probable-maximum
storm extremes, and narrow-band / Wirsching-Light fatigue damage.  The
dynamic variant adds inertia + damping on the Craig-Bampton reduced
basis by mode acceleration (exact static rows + modal correction — all
real arithmetic, no complex solves).  Finally a whole (Hs, Tp,
occurrence, heading) scatter diagram runs as ONE device program.

    python examples/12_frequency_domain.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np

import small_fem_solver_tpu as sf

coarse = sf.default_3leg_jacket()
n_seg = 4
refined = sf.refine_model(coarse, n_seg)
case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                   F_axial_kN=25100.0, F_shear_kN=2900.0,
                   custom_sw_tonnes=1100.0, sw_mode="custom")
prep = sf.prepare_condensed(coarse, refined, n_seg)

# -- one storm sea state: 3-hour extremes + fatigue, closed form ---------
sea = sf.make_random_sea(Hs=9.0, Tp=11.0, d=50.0, n_components=48, seed=0,
                         U_c=1.0)
fd = sf.spectral_response_prepared(prep, sea, case, T_storm_s=3 * 3600.0,
                                   exposure_years=25.0, curve="D-sea-cp",
                                   scf=1.5, occurrence=0.05)
g = int(np.argmax(np.asarray(fd.damage_wl)))
print(f"storm sea state (Hs=9 m, Tp=11 s, 48 components):")
print(f"  base shear: mean {float(fd.mean_base_shear_N)/1e3:.0f} kN, "
      f"sigma {float(fd.sigma_base_shear_N)/1e3:.0f} kN")
print(f"  displacement sigma {float(fd.sigma_disp_mm):.1f} mm, "
      f"3-h MPM {float(fd.mpm_disp_mm):.1f} mm")
print(f"  governing member {refined.member_names[g]}: sigma "
      f"{float(fd.sigma_stress[g]):.1f} MPa, 25-y W-L damage "
      f"{float(fd.damage_wl[g]):.2e}, MPM utilization "
      f"{float(fd.mpm_utilization[g]):.3f}")

# -- dynamic transfer on the Craig-Bampton basis --------------------------
# mode acceleration: exact static rows + modal correction q(w) - q(0);
# the stiff default jacket (T1 ~ 0.6 s) barely amplifies, as it should
fdd = sf.spectral_response_dynamic(coarse, refined, n_seg, sea, case,
                                   damping_ratio=0.02, prep=prep,
                                   T_storm_s=3 * 3600.0,
                                   exposure_years=25.0, curve="D-sea-cp",
                                   scf=1.5, occurrence=0.05)
print(f"dynamic CB transfer: damage ratio vs quasi-static at the "
      f"governing member "
      f"{float(fdd.damage_wl[g] / fd.damage_wl[g]):.3f} (stiff: ~1)")

# -- the long-term climate as ONE device program --------------------------
# an (Hs, Tp, occurrence, heading) scatter diagram; states stream through
# lax.map against the prepared factor (add mesh=Mesh(devs, ('cases',)) to
# shard the state axis over several devices)
scatter = [
    (2.5, 7.0, 0.55, 0.0),
    (4.5, 8.5, 0.25, 38.0),
    (6.5, 9.5, 0.12, 38.0),
    (8.5, 10.5, 0.05, 90.0),
    (10.5, 11.5, 0.02, 128.0),
]
lt = sf.scatter_fatigue_spectral(prep, case, scatter, d=50.0,
                                 exposure_years=25.0, curve="D-sea-cp",
                                 scf=1.5, n_components=48)
order = np.argsort(np.asarray(lt.damage_wl))[::-1][:5]
print(f"long-term scatter ({len(scatter)} states, "
      f"{sum(r[2] for r in scatter):.0%} of 25 y):")
for e in order:
    life = float(lt.life_years_wl[e])
    print(f"  {refined.member_names[e]:<22} D={float(lt.damage_wl[e]):.3e} "
          f"life={'inf' if np.isinf(life) else f'{life:.0f} y'}")

# -- N-year extreme response from the same transfer rows ------------------
ext = sf.long_term_extremes(lt, return_years=(10.0, 100.0),
                            fy=float(case.fy))
for r_i, y in enumerate((10, 100)):
    u = np.asarray(ext.utilization[r_i])
    e = int(np.argmax(u))
    print(f"{y}-year extreme: max utilization {u[e]:.3f} at "
          f"{refined.member_names[e]} "
          f"(governing state {ext.governing_state[r_i][e] + 1})")
