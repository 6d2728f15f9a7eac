"""Worked example 5: the three parallel axes, on a virtual 8-device mesh.

Demonstrates how the framework scales across a `jax.sharding.Mesh`
WITHOUT several accelerators: XLA's virtual CPU devices exercise the exact
sharded programs (same `shard_map` collectives, same partitioning) that
run across the cards of a real machine.

  1. case-parallel design sweep (`design_sweep(mesh=...)`),
  2. row-sharded distributed PCG (`analyze(solver='pcg', mesh=...)`),
  3. case-sharded CONDENSED envelope (`design_envelope_condensed(mesh=...)`).

    python examples/05_parallel_scaling.py
"""
import os
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

# 8 virtual devices; must be set before JAX initializes its backend
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.parallel.sweep import (critical_case, design_sweep,
                                                 make_case_batch,
                                                 make_wave_batch)

devs = np.array(jax.devices())
print(f"devices: {len(devs)} x {devs[0].platform}")
mesh = Mesh(devs, ("cases",))

model = sf.default_3leg_jacket(dtype=jnp.float32)
case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                   F_axial_kN=25100.0, F_shear_kN=2900.0,
                   custom_sw_tonnes=1100.0, sw_mode="custom")

# -- 1. case-parallel sweep: 16 wave heights, 2 per device --------------
B = 16
waves = make_wave_batch(np.linspace(2.0, 14.0, B), 9.4, 50.0, U_c=1.7,
                        model="stokes", N=5, n_modes=8, dtype=jnp.float32)
cases = make_case_batch(case, t_analysis=jnp.zeros(B, jnp.float32))
res = design_sweep(model, waves, cases, mesh=mesh, n_gauss=5)
crit = critical_case(res)                 # argmax = an all-reduce
print(f"sweep: {B} cases over {len(devs)} devices; governing case "
      f"{int(crit['index'])} at {float(crit['max_utilization']):.2%}")

# -- 2. tensor-parallel analog: DOF rows sharded, distributed PCG -------
refined = sf.refine_model(model, 2)
wave1 = sf.stokes_wave(9.5, 9.4, 50.0, 1.2, order=5, n_modes=8,
                       dtype=jnp.float32)
r = sf.analyze(refined, wave1, case, solver="pcg",
               mesh=Mesh(devs, ("dof",)), pcg_tol=1e-6, pcg_maxiter=5000,
               accel="analytic")
print(f"distributed PCG: {refined.n_dof} DOF rows sharded; "
      f"{int(r.solver_iters)} iterations, residual "
      f"{float(r.solver_residual):.1e}")

# -- 3. flagship production path: case-sharded condensed envelope -------
env = sf.design_envelope_condensed(model, refined, 2, waves, cases,
                                   n_steps=6, solve_dtype=jnp.float32,
                                   mesh=mesh)
print(f"condensed envelope: {B} cases x 6 phases @ {refined.n_dof} DOF "
      f"sharded; governing case {int(env.governing_case)} at "
      f"{float(env.max_util_per_case.max()):.2%}")
