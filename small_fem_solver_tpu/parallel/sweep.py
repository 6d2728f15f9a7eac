"""Design sweeps: vmapped case batches, sharded across the device mesh.

This is the first-class replacement for the parallelism the reference lacks
entirely (SURVEY.md section 2.2): the embarrassingly-parallel axes of the
workload — wave phase, load case (H, T, heading) — map to ``vmap`` on one
device and to a ``jax.sharding`` mesh across devices.  A thousand-case
storm-envelope sweep is ONE compiled program; each device holds a shard of
the case batch and the critical-case reduction rides an XLA all-reduce.

Batched wave construction notes: Airy and Stokes constructors are pure jnp
and vmap directly over (H, T, d, U_c); Fenton cases are solved per-case in
float64 on the host (setup) and stacked — all three lower to the same
fixed-size FourierWave pytree (pad ``n_modes``), so heterogeneous-model
batches evaluate through one kernel.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..api import (LoadCase, _check_shared_material, _recover,
                   _spring_dfac, assemble_loads)
from ..models.model import JacketModel
from ..ops import solve as solve_mod
from ..ops.assembly import assemble_dense
from ..ops.beams import element_stiffness
from ..ops.morison import hydro_diameter_m, hydro_members, morison_loads
from ..ops.stokes import stokes_wave
from ..ops.waves import FourierWave, airy_wave


def stack_waves(waves) -> FourierWave:
    """Stack same-shaped FourierWave pytrees along a new leading case axis."""
    if len({w.E.shape[-1] for w in waves}) != 1:
        raise ValueError("pad waves to a common n_modes before stacking")
    # static fields must agree for a single batched kernel
    clamp = {w.clamp_z for w in waves}
    if len(clamp) != 1:
        raise ValueError("cannot batch clamped and unclamped waves together; "
                         "rebuild with a uniform clamp_z")
    return jax.tree.map(lambda *xs: jnp.stack(xs), *waves)


def make_wave_batch(H, T, d, U_c=0.0, model: str = "stokes", N: int = 5,
                    n_modes: int = 20, dtype=jnp.float32) -> FourierWave:
    """Build a batched FourierWave from arrays of (H, T) [and scalar d, U_c].

    For 'airy'/'stokes' the constructors trace once and vmap over the case
    axis (wave setup itself runs on the device); 'fenton' runs ONE vmapped
    float64 continuation-Newton over the whole batch on the host CPU
    (:func:`..ops.fenton.fenton_wave_batch`) — a 1,000-case nonlinear storm
    population solves in one compiled program.
    """
    H = np.atleast_1d(np.asarray(H, dtype=np.float64))
    T = np.broadcast_to(np.asarray(T, dtype=np.float64), H.shape)
    if model == "airy":
        f = jax.vmap(lambda h, t: airy_wave(h, t, d, U_c, n_modes=n_modes,
                                            dtype=dtype))
        return f(jnp.asarray(H, dtype=dtype), jnp.asarray(T, dtype=dtype))
    if model == "stokes":
        f = jax.vmap(lambda h, t: stokes_wave(h, t, d, U_c, order=min(N, 5),
                                              n_modes=n_modes, dtype=dtype))
        return f(jnp.asarray(H, dtype=dtype), jnp.asarray(T, dtype=dtype))
    if model == "fenton":
        from ..ops.fenton import fenton_wave_batch
        return fenton_wave_batch(H, T, d, U_c, N=N, n_modes=n_modes,
                                 dtype=dtype)
    raise ValueError(f"unknown wave model {model!r}")


def make_case_batch(base: LoadCase, **overrides) -> LoadCase:
    """Broadcast a LoadCase to a batch, overriding per-case fields.

    ``overrides`` maps field name -> [B] array; scalar fields broadcast.
    """
    sizes = {np.asarray(v).shape[0] for v in overrides.values()
             if np.asarray(v).ndim > 0}
    B = sizes.pop() if sizes else 1
    import dataclasses
    vals = {}
    for f in dataclasses.fields(base):
        if f.name in LoadCase._STATIC_FIELDS:
            continue
        v = overrides.get(f.name, getattr(base, f.name))
        v = jnp.asarray(v)
        if v.ndim == 0:
            v = jnp.broadcast_to(v, (B,))
        vals[f.name] = v
    return dataclasses.replace(base, **vals)


def design_sweep(model: JacketModel, waves: FourierWave, cases: LoadCase,
                 solver: str = "chol", n_gauss: int = 15,
                 accel: str = "analytic", mesh: Mesh | None = None,
                 support_stiffness=None):
    """Analyze a batch of (wave, case) pairs as one compiled program.

    With ``mesh`` (a 1-D device mesh with axis 'cases'), the batch is
    sharded across devices — the device-mesh equivalent of a distributed
    parameter sweep; without it, the batch vmaps on one device.

    Material properties must be shared across the batch (enforced), so the
    stiffness is factored ONCE outside the vmapped per-case body; each case
    costs hydrodynamic loads + one multi-RHS triangular solve + recovery.
    ('lu' and 'chol' produce the same solution of the SPD system; large-mesh
    batches belong to ``design_envelope_condensed``.)

    Returns the batched AnalysisResults pytree (leading case axis).
    """
    if solver not in ("chol", "lu"):
        raise ValueError(f"design_sweep supports dense solvers "
                         f"('chol'/'lu'); got {solver!r}")
    _check_shared_material(cases)
    free_np, fixed_np = solve_mod.free_fixed_dofs(model.fixed_mask)
    ks_nodes = None
    if support_stiffness is not None:
        ks = solve_mod.support_spring_nodes(model.fixed_mask,
                                            support_stiffness)
        ks_nodes = jnp.asarray(ks).astype(model.coords.dtype)
        free_np = np.arange(6 * model.coords.shape[0])
    free, fixed = jnp.asarray(free_np), jnp.asarray(fixed_np)

    if mesh is not None:
        case_sharding = NamedSharding(mesh, P("cases"))
        replicated = NamedSharding(mesh, P())
        waves = jax.device_put(waves, case_sharding)
        cases = jax.device_put(cases, case_sharding)
        model = jax.device_put(model, replicated)
    return _design_sweep_jit(model, waves, cases.cast(model.coords.dtype),
                             free, fixed, ks_nodes, n_gauss, accel)


@partial(jax.jit, static_argnames=("n_gauss", "accel"))
def _design_sweep_jit(model, waves, cases, free, fixed, ks_nodes, n_gauss,
                      accel):
    with jax.default_matmul_precision("highest"):
        G = cases.E[0] / (2.0 * (1.0 + cases.nu[0]))
        Kg, K_local, T, L_m = element_stiffness(
            model.coords, model.conn, model.sections, model.sect_id,
            cases.E[0], G, release=model.release)
        K = assemble_dense(Kg, model.conn, model.n_dof)
        fac = _spring_dfac(K, ks_nodes, free)

        def one(wave, case):
            conn_h, D_m, Cd_h, Cm_h = hydro_members(
                model, case.marine_growth_mm, case.Cd, case.Cm)
            mor = morison_loads(wave, model.coords, conn_h, D_m,
                                case.wave_dir_deg, case.current_dir_deg,
                                Cd_h, Cm_h, case.rho_water,
                                case.t_analysis, n_gauss=n_gauss, accel=accel,
                                slam_cs=case.slam_cs)
            F = assemble_loads(model, case, mor.nodal_forces, L_m)
            U = solve_mod.solve_factored(fac, F)
            return _recover(model, case, K, U, F, fixed, K_local, T, L_m, mor)

        return jax.vmap(one)(waves, cases)


def critical_case(results) -> dict:
    """Reduce a sweep to its governing case (max utilization).

    On a sharded batch the argmax induces an XLA all-reduce across devices.
    """
    util = jnp.max(results.utilization, axis=-1)     # [B]
    i = jnp.argmax(util)
    return {
        "index": i,
        "max_utilization": util[i],
        "max_displacement_mm": results.max_displacement_mm[i],
    }
