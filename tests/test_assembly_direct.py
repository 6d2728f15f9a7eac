"""Direct-write (gather-free) BCSR assembly vs the generic path.

ops/assembly.py::assemble_bcsr_direct emits entries in [diag | ij | ji]
block order with the geometry permuted into lane order at prepare time —
zero runtime gathers (written for an accelerator's lane layout; on the
H100 the two-tier gather path measured faster, see PERF.md).
Parity must hold block-for-block against assemble_bcsr and through every
order-agnostic BCSR consumer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.api import _cached_bcsr_pattern
from small_fem_solver_tpu.ops.assembly import (assemble_bcsr,
                                               assemble_bcsr_direct,
                                               bcsr_block_diagonal,
                                               bcsr_matvec, bcsr_to_dense,
                                               prepare_direct_assembly)
from small_fem_solver_tpu.ops.beams import element_global_stiffness


@pytest.mark.parametrize("n_seg,dtype,tol", [
    (1, jnp.float64, 1e-12),    # unrefined: hub extras + duplicate edges
    (8, jnp.float64, 1e-12),    # chains: mostly degree-2 diagonal pipeline
    (8, jnp.float32, 5e-6),
])
def test_direct_assembly_matches_generic(n_seg, dtype, tol):
    model = sf.refine_model(sf.default_3leg_jacket(dtype=dtype), n_seg)
    E = jnp.asarray(210000.0, dtype)
    G = E / 2.6
    pattern = _cached_bcsr_pattern(model.conn, model.n_nodes)
    Kg = element_global_stiffness(model.coords, model.conn, model.sections,
                                  model.sect_id, E, G)
    A = assemble_bcsr(Kg, pattern)
    prep = prepare_direct_assembly(model.coords, model.conn, model.sect_id,
                                   model.n_nodes)
    Ad = assemble_bcsr_direct(prep, model.sections, E, G)
    assert Ad.pattern.n_blocks == pattern.n_blocks

    K1 = np.asarray(bcsr_to_dense(A))
    K2 = np.asarray(bcsr_to_dense(Ad))
    sc = np.abs(K1).max()
    assert np.abs(K2 - K1).max() / sc < tol

    x = jnp.asarray(np.random.default_rng(0).standard_normal(model.n_dof),
                    dtype)
    y1 = np.asarray(bcsr_matvec(A, x))
    y2 = np.asarray(bcsr_matvec(Ad, x))
    assert np.abs(y2 - y1).max() / np.abs(y1).max() < tol

    d1 = np.asarray(bcsr_block_diagonal(A))
    d2 = np.asarray(bcsr_block_diagonal(Ad))
    assert np.abs(d2 - d1).max() / np.abs(d1).max() < tol


def test_direct_assembly_scale_matches_scaled_coords():
    """The call-time uniform geometry scale equals re-preparing with
    scaled coordinates (the bench's varying-geometry axis)."""
    model = sf.refine_model(sf.default_3leg_jacket(), 4)
    E = jnp.float64(210000.0)
    G = E / 2.6
    prep = prepare_direct_assembly(model.coords, model.conn, model.sect_id,
                                   model.n_nodes)
    s = 1.007
    A_s = assemble_bcsr_direct(prep, model.sections, E, G,
                               scale=jnp.float64(s))
    prep2 = prepare_direct_assembly(np.asarray(model.coords) * s,
                                    model.conn, model.sect_id,
                                    model.n_nodes)
    A_2 = assemble_bcsr_direct(prep2, model.sections, E, G)
    sc = float(jnp.abs(A_2.blocks).max())
    assert float(jnp.abs(A_s.blocks - A_2.blocks).max()) / sc < 1e-12
