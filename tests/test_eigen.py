"""Device-resident eigensolvers (ops/eigen.py): Jacobi small-matrix eigh,
Bathe subspace iteration, block power iteration — and the forced-'subspace'
paths of the modal/buckling/dynamic pipelines, cross-checked on CPU against
the full-eigh routes (written for an accelerator without jnp.linalg.eigh,
LU or complex solves; kept until measured on the GPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla

import small_fem_solver_tpu as sf
from small_fem_solver_tpu.ops.eigen import (eigh_general_small, jacobi_eigh,
                                            subspace_eigh, subspace_largest)


@pytest.mark.parametrize("m", [5, 8, 17, 34])
def test_jacobi_eigh_matches_lapack(m):
    rng = np.random.default_rng(m)
    A = rng.standard_normal((3, m, m))
    A = A + np.swapaxes(A, -1, -2)
    w, V = jacobi_eigh(jnp.asarray(A))
    w_ref = np.linalg.eigvalsh(A)
    np.testing.assert_allclose(np.asarray(w), w_ref, rtol=1e-12,
                               atol=1e-12 * np.abs(w_ref).max())
    # eigenvector residual + orthonormality
    Vn = np.asarray(V)
    res = np.einsum("bij,bjk->bik", A, Vn) - Vn * np.asarray(w)[:, None, :]
    assert np.abs(res).max() < 1e-11 * np.abs(w_ref).max()
    gram = np.einsum("bji,bjk->bik", Vn, Vn)
    assert np.abs(gram - np.eye(m)).max() < 1e-12


def test_eigh_general_small_matches_scipy():
    rng = np.random.default_rng(1)
    m = 16
    A = rng.standard_normal((m, m))
    A = A + A.T
    Bm = rng.standard_normal((m, m))
    B = Bm @ Bm.T + m * np.eye(m)
    lam, V = eigh_general_small(jnp.asarray(A), jnp.asarray(B))
    lam_ref = sla.eigh(A, B, eigvals_only=True)
    np.testing.assert_allclose(np.asarray(lam), lam_ref, rtol=1e-11,
                               atol=1e-12)
    # B-orthonormal eigenvectors
    gram = np.asarray(V).T @ B @ np.asarray(V)
    assert np.abs(gram - np.eye(m)).max() < 1e-10


def _jacket_km():
    from small_fem_solver_tpu.ops.dynamics import _build_km
    model = sf.default_3leg_jacket()
    K, M, free, _ = _build_km(model, 210000.0, 0.3, 1100.0, None, 1025.0)
    return K[jnp.ix_(free, free)], M[jnp.ix_(free, free)]


def test_subspace_eigh_on_jacket_matches_lapack():
    """The device path of _modal_from_ff: lowest 10 generalized eigenpairs
    of the real jacket (K, M) to LAPACK accuracy (measured 4.6e-11 at 8
    iterations; we assert 1e-8 at the production 16)."""
    K_ff, M_ff = _jacket_km()
    lam, V = subspace_eigh(K_ff, M_ff, 10, n_iter=16)
    lam_ref = sla.eigh(np.asarray(K_ff), np.asarray(M_ff),
                       eigvals_only=True)[:10]
    np.testing.assert_allclose(np.asarray(lam), lam_ref, rtol=1e-8)
    # M-orthonormal shapes
    gram = np.asarray(V).T @ np.asarray(M_ff) @ np.asarray(V)
    assert np.abs(gram - np.eye(10)).max() < 1e-8


def test_subspace_eigh_batched():
    """Batched over a leading axis (the Craig-Bampton per-chain use), on
    beam-like spectra: eigenvalues spread over decades like a chain's
    fixed-interface modes (lam ~ i^2 / i^4 families), which is the regime
    the solver serves.  (Artificially CLUSTERED random spectra converge
    slowly by the lam_i/lam_{m+1} theory — that is inherent to subspace
    iteration, not a defect; the structural paths never see them.)"""
    rng = np.random.default_rng(3)
    n, b = 60, 4
    lam_true = np.stack([np.arange(1, n + 1) ** 2 * (1 + 0.1 * i)
                         for i in range(b)]).astype(np.float64)
    Qm = np.linalg.qr(rng.standard_normal((b, n, n)))[0]
    K = np.einsum("bij,bj,bkj->bik", Qm, lam_true, Qm)
    M = np.broadcast_to(np.eye(n), (b, n, n)).copy()
    lam, V = subspace_eigh(jnp.asarray(K), jnp.asarray(M), 5, n_iter=24)
    for i in range(b):
        ref = np.sort(lam_true[i])[:5]
        np.testing.assert_allclose(np.asarray(lam[i]), ref, rtol=1e-8)


def test_subspace_largest_matches_lapack():
    """Block power iteration on a buckling-like spectrum: a handful of
    governing top modes well clear of the rest (the global sway/torsion
    buckling family), exact top-eigenvalue recovery."""
    rng = np.random.default_rng(5)
    n = 120
    lam_true = np.concatenate([np.array([50.0, 48.0, 41.0, 35.0]),
                               np.linspace(20.0, -30.0, n - 4)])
    Qm = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A = Qm @ np.diag(lam_true) @ Qm.T
    lam, V = subspace_largest(jnp.asarray(A), 4)
    lam_ref = np.sort(lam_true)[::-1][:4]
    np.testing.assert_allclose(np.asarray(lam), lam_ref, rtol=1e-9)
    # eigenVECTORS converge at ratio^k (values at ratio^2k): looser bar
    res = A @ np.asarray(V) - np.asarray(V) * np.asarray(lam)
    assert np.abs(res).max() < 1e-6 * lam_ref[0]


def test_modal_analysis_subspace_backend_matches_lapack(monkeypatch):
    """_modal_from_ff with the forced 'subspace' backend equals the LAPACK
    route on the default jacket."""
    from small_fem_solver_tpu.ops import dynamics
    ref = dynamics.modal_analysis(sf.default_3leg_jacket(), n_modes=8,
                                  topside_mass_t=1100.0)
    monkeypatch.setattr(dynamics, "_eigh_backend", lambda method="auto":
                        "subspace")
    dev = dynamics.modal_analysis(sf.default_3leg_jacket(), n_modes=8,
                                  topside_mass_t=1100.0)
    np.testing.assert_allclose(np.asarray(dev.frequencies_hz),
                               np.asarray(ref.frequencies_hz), rtol=1e-8)
    # shapes agree up to sign
    a = np.asarray(dev.mode_shapes)
    b = np.asarray(ref.mode_shapes)
    for i in range(a.shape[0]):
        s = np.sign(np.dot(a[i], b[i]))
        np.testing.assert_allclose(a[i] * s, b[i],
                                   atol=1e-6 * np.abs(b[i]).max())


def test_dynamic_response_subspace_backend_matches_lapack(monkeypatch):
    """dynamic_response end-to-end with the device eigen backend: same
    Rayleigh calibration, same utilizations (cross-check: the subspace
    path must agree with the full eigh at rtol <= 1e-6)."""
    from small_fem_solver_tpu.ops import dynamics
    model = sf.default_3leg_jacket()
    wave = sf.airy_wave(10.0, 9.4, 50.0, 1.0)
    case = sf.LoadCase(wave_dir_deg=0.0, current_dir_deg=0.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    ref = dynamics.dynamic_response(model, wave, case, n_harmonics=4,
                                    n_steps=24)
    monkeypatch.setattr(dynamics, "_eigh_backend", lambda method="auto":
                        "subspace")
    dev = dynamics.dynamic_response(model, wave, case, n_harmonics=4,
                                    n_steps=24)
    np.testing.assert_allclose(float(dev.rayleigh_alpha),
                               float(ref.rayleigh_alpha), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(dev.utilization),
                               np.asarray(ref.utilization), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(float(dev.daf), float(ref.daf), rtol=1e-6)


def test_cb_chain_subspace_matches_lapack():
    """At deep refinement (chain dim N >= 16 m) the Craig-Bampton
    fixed-interface modes switch to subspace iteration EVEN ON CPU (the
    full [N, N] LAPACK spectrum is wasted on m retained modes — this was
    most of the r03 644-s response-spectrum tail).  n_seg = 40 sits just
    above the switch: compare against the same reduction computed with the
    full LAPACK route."""
    from small_fem_solver_tpu.ops import dynamics

    model = sf.default_3leg_jacket()
    n_seg = 40          # N = 234 >= 16 * 12
    refined = sf.refine_model(model, n_seg)
    auto = dynamics.modal_analysis_condensed(model, refined, n_seg,
                                             n_modes=10,
                                             topside_mass_t=1100.0,
                                             n_chain_modes=12)
    # force the full-eigh route by raising the switch threshold: patch the
    # backend chooser AND the size heuristic via a huge m... simplest is
    # monkeypatching numpy of the condition: re-run with n_chain_modes
    # large enough that N < 16 m (m = 15 -> 16 m = 240 > 234)
    ref = dynamics.modal_analysis_condensed(model, refined, n_seg,
                                            n_modes=10,
                                            topside_mass_t=1100.0,
                                            n_chain_modes=15)
    # more retained chain modes only IMPROVES the reduced model, so the
    # comparison carries BOTH the subspace convergence error and the
    # m = 12-vs-15 CB truncation difference (the reference is consistently
    # lower) — measured 4e-6 combined; 1e-5 bounds it with headroom
    np.testing.assert_allclose(np.asarray(auto.frequencies_hz),
                               np.asarray(ref.frequencies_hz), rtol=1e-5)


def test_buckling_subspace_backend_matches_lapack(monkeypatch):
    from small_fem_solver_tpu.ops import buckling, dynamics
    model = sf.default_3leg_jacket()
    wave = sf.airy_wave(17.038, 9.4, 50.0, 1.7)
    case = sf.LoadCase(wave_dir_deg=38.0, current_dir_deg=38.0,
                       F_axial_kN=25100.0, F_shear_kN=2900.0,
                       custom_sw_tonnes=1100.0, sw_mode="custom")
    res = sf.analyze(model, wave, case, solver="chol")
    ref = buckling.buckling_analysis(model, res, n_modes=3)
    monkeypatch.setattr(dynamics, "_eigh_backend", lambda method="auto":
                        "subspace")
    dev = buckling.buckling_analysis(model, res, n_modes=3)
    # block power iteration: governing factor tight, higher (possibly
    # near-degenerate sway-pair) modes to engineering accuracy
    np.testing.assert_allclose(float(dev.load_factor[0]),
                               float(ref.load_factor[0]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(dev.load_factor),
                               np.asarray(ref.load_factor), rtol=1e-3)


def test_eigh_general_small_illconditioned_gram_f32():
    """Bathe subspace callers pass Gram matrices B = W^T M W whose
    condition is the SQUARE of the pencil's — a plain f32 Cholesky NaN'd
    there (round-4 regression: every chain of the n_seg=2 dynamic fatigue
    screen).  The scaled+ridged reduction must stay finite and keep the
    well-conditioned eigenpairs accurate."""
    rng = np.random.default_rng(7)
    m = 6
    Q, _ = np.linalg.qr(rng.standard_normal((m, m)))
    # spectrum spanning 2e8 — cond(B) ~ the measured failing case
    w = np.array([2.4e-10, 1.4e-6, 1.7e-6, 4.4e-3, 3.2e-2, 4.6e-2])
    B = (Q * w) @ Q.T
    A = rng.standard_normal((m, m))
    A = (A + A.T) * 1e3
    lam32, V32 = eigh_general_small(jnp.asarray(A, jnp.float32),
                                    jnp.asarray(B, jnp.float32))
    assert np.isfinite(np.asarray(lam32)).all()
    assert np.isfinite(np.asarray(V32)).all()
    # f64 with the ridge still matches LAPACK: the ridge (~4e-14 on the
    # scaled unit diagonal) perturbs the 5e-9-weight direction's
    # eigenvalue relatively by ~1e-5 at worst (measured 2.4e-6); the
    # well-conditioned eigenvalues are untouched
    lam64, _ = eigh_general_small(jnp.asarray(A), jnp.asarray(B))
    lam_ref = sla.eigh(A, B, eigvals_only=True)
    np.testing.assert_allclose(np.asarray(lam64), lam_ref, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(lam64)[1:], lam_ref[1:], rtol=1e-8)


def test_cb_reduce_small_chain_f32_finite_and_accurate():
    """n_seg = 2 Craig-Bampton in float32 (the fast-path dtype):
    the short-chain direct Rayleigh-Ritz path must produce finite modes
    that match the f64 reduction (round-4 regression test: the matrix-free
    inverse iteration NaN'd 16/51 chains here)."""
    from small_fem_solver_tpu.ops.dynamics import _cb_reduce

    model64 = sf.default_3leg_jacket()
    model32 = sf.default_3leg_jacket(dtype=jnp.float32)
    out = {}
    for tag, model in (("f64", model64), ("f32", model32)):
        refined = sf.refine_model(model, 2)
        cb = _cb_reduce(model, refined, 2, 210000.0, 0.3, 1100.0, 12)
        K_red, M_red = np.asarray(cb.K_red), np.asarray(cb.M_red)
        assert np.isfinite(K_red).all(), tag
        assert np.isfinite(M_red).all(), tag
        free = np.asarray(cb.free)
        lam = sla.eigh(K_red[np.ix_(free, free)].astype(np.float64),
                       M_red[np.ix_(free, free)].astype(np.float64),
                       eigvals_only=True)
        out[tag] = np.sqrt(np.clip(lam[:10], 0, None)) / (2 * np.pi)
    np.testing.assert_allclose(out["f32"], out["f64"], rtol=2e-4)
