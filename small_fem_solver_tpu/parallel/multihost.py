"""Multi-host (DCN) design sweeps.

Single-host scaling rides NVLink through ``jax.sharding`` meshes
(parallel/sweep.py, parallel/pcg_dist.py).  This module adds the multi-host
layer for very large storm envelopes: one process per host, the case axis
sharded over the GLOBAL device set, wave setup done host-locally (each
process solves only its own shard's Fenton collocations — the only
host-side per-case work), and results assembled from process-local shards
with ``jax.make_array_from_process_local_data``.  Cross-host traffic is the
per-case reductions only, riding DCN; everything per-case stays on the
owning host's devices.

On a single process every function degenerates to the local-mesh behavior
(tested); on a pod slice, call :func:`init_multihost` first — mirroring the
standard ``jax.distributed.initialize`` contract.
"""
from __future__ import annotations

import numpy as np


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> bool:
    """Initialize ``jax.distributed`` for a multi-process run.

    No-op (returns False) when running single-process — so driver scripts
    can call it unconditionally.  With arguments (or the standard cluster
    env vars), forwards to ``jax.distributed.initialize`` and returns True.
    """
    import jax

    if num_processes in (None, 0, 1) and coordinator_address is None:
        return False
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def global_case_mesh(axis: str = "cases"):
    """1-D mesh over ALL global devices (every process's chips)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def process_local_slice(n_cases: int) -> slice:
    """The contiguous case range this process owns (block layout)."""
    import jax

    p = jax.process_index()
    n = jax.process_count()
    per = -(-n_cases // n)
    return slice(p * per, min((p + 1) * per, n_cases))


def shard_cases_from_local(pytree_local, n_cases: int, mesh, axis="cases"):
    """Assemble a globally case-sharded pytree from each process's local
    block (built with :func:`process_local_slice`).

    Single-process: a plain ``device_put`` with the case sharding.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P(axis))
    if jax.process_count() == 1:
        return jax.device_put(pytree_local, sharding)

    def make(x):
        global_shape = (n_cases,) + tuple(np.asarray(x).shape[1:])
        return jax.make_array_from_process_local_data(
            sharding, np.asarray(x), global_shape)

    return jax.tree.map(make, pytree_local)


def multihost_design_envelope(model, H_list, T, d, U_c, base_case,
                              wave_model: str = "fenton", N: int = 18,
                              n_modes: int = 18, n_steps: int = 36,
                              dtype=None, **envelope_kw):
    """Storm envelope over (H) cases sharded across every host's devices.

    Wave setup is HOST-BATCHED: each process runs the (CPU-bound, float64)
    Fenton collocation solves only for its own case block, then the blocks
    are assembled into one globally sharded batch.  The envelope itself is
    ``api.design_envelope`` with the global mesh.
    """
    import jax
    import jax.numpy as jnp

    from ..api import design_envelope
    from .sweep import make_case_batch, make_wave_batch

    dtype = dtype or jnp.float32
    H = np.asarray(H_list, dtype=np.float64)
    n_cases = H.shape[0]
    mesh = global_case_mesh()

    sl = process_local_slice(n_cases)
    waves_local = make_wave_batch(H[sl], T, d, U_c=U_c, model=wave_model,
                                  N=N, n_modes=n_modes, dtype=dtype)
    cases_local = make_case_batch(
        base_case, t_analysis=jnp.zeros(sl.stop - sl.start, dtype))

    waves = shard_cases_from_local(waves_local, n_cases, mesh)
    cases = shard_cases_from_local(cases_local, n_cases, mesh)
    return design_envelope(model, waves, cases, n_steps=n_steps,
                           mesh=mesh, **envelope_kw)


def multihost_design_envelope_condensed(coarse, refined, n_seg, H_list, T,
                                        d, U_c, base_case,
                                        wave_model: str = "fenton",
                                        N: int = 18, n_modes: int = 18,
                                        n_steps: int = 36, dtype=None,
                                        solve_dtype=None, **envelope_kw):
    """Flagship-scale storm envelope across hosts: the REFINED mesh's exact
    chain condensation (``api.design_envelope_condensed``) with the case
    axis sharded over the global device set.  Wave setup is host-batched
    exactly like :func:`multihost_design_envelope`; each device factors the
    case-independent chains locally (replicated compute), so the only DCN
    traffic is the member-envelope pmax.
    """
    import jax.numpy as jnp

    from ..api import design_envelope_condensed
    from .sweep import make_case_batch, make_wave_batch

    dtype = dtype or jnp.float32
    solve_dtype = solve_dtype or jnp.float32
    H = np.asarray(H_list, dtype=np.float64)
    n_cases = H.shape[0]
    mesh = global_case_mesh()

    sl = process_local_slice(n_cases)
    waves_local = make_wave_batch(H[sl], T, d, U_c=U_c, model=wave_model,
                                  N=N, n_modes=n_modes, dtype=dtype)
    cases_local = make_case_batch(
        base_case, t_analysis=jnp.zeros(sl.stop - sl.start, dtype))

    waves = shard_cases_from_local(waves_local, n_cases, mesh)
    cases = shard_cases_from_local(cases_local, n_cases, mesh)
    return design_envelope_condensed(coarse, refined, n_seg, waves, cases,
                                     n_steps=n_steps,
                                     solve_dtype=solve_dtype, mesh=mesh,
                                     **envelope_kw)
