"""First-order reliability (FORM) of the structural response under the
long-term wave climate.

Beyond-reference capability (the reference checks exactly ONE deterministic
storm typed into its Wave tab, `JacketAnalysisGUI_v2.py:1804-1822`): design
codes ask for the PROBABILITY that the governing response exceeds its limit
over the structure's life.  `ops/metocean.py` already provides the inverse
form of the question (IFORM: environmental contours at a target return
period, response shape ignored).  This module answers the direct form:

    g(Hs, Tp) = threshold - response(Hs, Tp)        (failure when g < 0)

is searched in the standard-normal space of the environment for the
most-probable failure point (the design point) with the improved
Hasofer-Lind-Rackwitz-Fiessler (iHL-RF) algorithm — reliability index
beta = alpha . u*, failure probability Phi(-beta) per sea state, the
physical design point (Hs*, Tp*), and the alpha sensitivity vector that
says how much of the risk is wave height vs period.  This is the standard
ISO 2394 / DNV recipe, sharing `ops/metocean.py`'s Rosenblatt transform so
FORM and IFORM are exactly consistent (tested identity: a monotone
response's FORM beta equals the return-period beta).

The generic `form()` solver takes any limit state over any number of
standard-normal variables; gradients come from a user closure (e.g.
`jax.grad` through the differentiable pipeline) or, by default, central
differences in u-space — the environment has 2-3 dimensions and every
evaluation is one compiled phase scan, so the finite-difference tax is a
handful of fast device calls per iteration.

All host-side orchestration (numpy): the hot work inside each limit-state
evaluation is the existing jitted analysis.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np

from .metocean import JointHsTp, _phi, rosenblatt_hs_tp


class FormResult(NamedTuple):
    """Design point and reliability index from the iHL-RF search."""

    beta: float           # reliability index alpha . u* (negative if the
                          #   median state already fails)
    pf: float             # failure probability per trial = Phi(-beta)
    u_star: np.ndarray    # [n] design point, standard-normal space
    x_star: np.ndarray    # [n] physical design point (x_of_u(u*); = u* if
                          #   no transform was given)
    alpha: np.ndarray     # [n] unit sensitivity vector (-grad g / |grad g|)
    g_star: float         # residual limit-state value at u* (~0)
    n_iter: int
    n_evals: int          # total limit-state evaluations (incl. gradients)
    converged: bool


def _breaking_clip(hs, tp, d: float, h_min: float, cap: float,
                   steepness_cap: float = 0.142,
                   t_window: tuple[float, float] = (2.0, 30.0)):
    """Clamp (Hs, Tp) probes to physically realizable regular waves.

    FORM trial steps roam the whole standard-normal plane, including corners
    (tiny Tp, huge Hs) where no ocean wave exists: past the Miche breaking
    height H_b = 0.142 L tanh(kd) the wave theories return either unphysical
    monster kinematics (which fabricate spurious design points — observed
    governing-beta drops from 3.9 to 2.0 on the default jacket) or NaNs
    (cosh(kz) overflow at sub-second Tp, which kills the gradient search).
    Saturating at breaking keeps the limit state defined and the far tail
    flat, exactly like the existing 0.75 d depth cap.  Host-side numpy
    Newton for the dispersion solve — a handful of scalars per call.
    """
    tp = np.clip(np.asarray(tp, np.float64), t_window[0], t_window[1])
    hs = np.asarray(hs, np.float64)
    om = 2.0 * np.pi / tp
    g_grav = 9.80665
    k = om * om / g_grav                      # deep-water start
    for _ in range(40):
        kd = np.minimum(k * d, 350.0)
        th = np.tanh(kd)
        f = om * om - g_grav * k * th
        df = -g_grav * (th + kd / np.cosh(kd) ** 2)
        k = k - f / df
    h_b = steepness_cap * (2.0 * np.pi / k) * np.tanh(np.minimum(k * d,
                                                                 350.0))
    return np.clip(hs, h_min, np.minimum(cap, h_b)), tp


def _fd_grad(g: Callable, u: np.ndarray, step: float) -> np.ndarray:
    """Central-difference gradient of g in u-space."""
    n = u.size
    grad = np.zeros(n)
    for i in range(n):
        e = np.zeros(n)
        e[i] = step
        grad[i] = (g(u + e) - g(u - e)) / (2.0 * step)
    return grad


def form(g: Callable[[np.ndarray], float], n_dim: int,
         x_of_u: Callable[[np.ndarray], Sequence[float]] | None = None,
         grad: Callable[[np.ndarray], np.ndarray] | None = None,
         u0: np.ndarray | None = None, fd_step: float = 1e-4,
         tol: float = 1e-4, max_iter: int = 50) -> FormResult:
    """iHL-RF search for the design point of limit state ``g`` (< 0 fails).

    ``g`` takes a standard-normal point ``u`` ([n_dim]); use ``x_of_u`` to
    report the physical design point (e.g. the Rosenblatt closure from
    :func:`hs_tp_limit_state`).  ``grad`` (optional) returns dg/du at u —
    pass a ``jax.grad`` closure when the limit state is traceable; the
    default is a central difference with ``fd_step``.

    Each step takes the classical HL-RF update direction and backtracks on
    the Zhang & Der Kiureghian merit function m(u) = 0.5|u|^2 + c|g(u)|
    (c kept above |u|/|grad g|), which makes the iteration globally
    convergent on limit states where plain HL-RF oscillates.

    Convergence: |g| < tol * max(1, |g(0)|)  AND  the design point is
    parallel to alpha within tol.  On only piecewise-smooth limit states
    (max-over-phases responses) whose design point sits at a gradient kink,
    plain HL-RF limit-cycles with beta already stable; the search then
    accepts the best (lowest-merit) on-surface iterate once three
    iterations bring no merit improvement — standard iHL-RF practice —
    and reports beta as the signed DISTANCE |u*| (identical to alpha . u*
    at smooth converged points).
    """
    u = np.zeros(n_dim) if u0 is None else np.asarray(u0, np.float64).copy()
    if u.shape != (n_dim,):
        raise ValueError(f"u0 must have shape ({n_dim},), got {u.shape}")
    n_evals = 0

    def geval(uu):
        nonlocal n_evals
        n_evals += 1
        return float(g(np.asarray(uu, np.float64)))

    g_u = geval(u)
    g_scale = max(1.0, abs(g_u))
    converged = False
    kink_accepted = False
    best_n, best_u, best_g, best_gr = np.inf, u.copy(), g_u, None
    stall = 0
    it = 0
    for it in range(1, max_iter + 1):
        if grad is not None:
            gr = np.asarray(grad(u), np.float64)
        else:
            gr = _fd_grad(geval, u, fd_step)  # geval counts the 2n calls
        gn = float(np.linalg.norm(gr))
        if not np.isfinite(gn) or gn < 1e-300:
            break  # flat limit state: no descent information
        alpha = -gr / gn
        # convergence test at the CURRENT point
        u_par = float(alpha @ u)
        ortho = float(np.linalg.norm(u - u_par * alpha))
        if abs(g_u) < tol * g_scale and ortho < tol * max(1.0, abs(u_par)):
            converged = True
            break
        # minimum-norm ON-SURFACE iterate for the kink (stagnation)
        # acceptance (merit values are not comparable across iterations:
        # the penalty weight and |grad| change)
        u_norm = float(np.linalg.norm(u))
        if abs(g_u) < 10.0 * tol * g_scale and u_norm < best_n - 1e-3:
            best_n, best_u, best_g, best_gr = u_norm, u.copy(), g_u, gr.copy()
            stall = 0
        else:
            stall += 1
        if stall >= 3 and np.isfinite(best_n):
            u, g_u, gr = best_u, best_g, best_gr
            converged = True
            kink_accepted = True
            break
        C = max(2.0 * abs(u_par), 2.0)
        # HL-RF target with merit-minimizing step selection: plain HL-RF
        # zigzags on curved limit states (the lam = 0.5 midpoint kills the
        # oscillation), so pick the candidate minimizing the distance-
        # normalized merit 0.5|u|^2 + C |g|/|grad g| (|g|/|grad| is the
        # linearized distance to the surface, so the merit is scale-free).
        u_new = (u_par + g_u / gn) * alpha
        d = u_new - u
        best = None
        for lam in (1.0, 0.5, 0.25):
            u_try = u + lam * d
            g_try = geval(u_try)
            m = 0.5 * float(u_try @ u_try) + C * abs(g_try) / gn
            if best is None or m < best[0]:
                best = (m, u_try, g_try)
        _, u, g_u = best

    gn = float(np.linalg.norm(gr)) if "gr" in locals() else 0.0
    alpha = (-gr / gn) if gn > 0 else np.zeros(n_dim)
    if kink_accepted:
        # the kinked design point is not gradient-parallel; beta is the
        # distance, signed by which side of the surface the origin sits on
        beta = float(np.copysign(np.linalg.norm(u), alpha @ u))
    else:
        beta = float(alpha @ u)
    x_star = (np.asarray(x_of_u(u), np.float64) if x_of_u is not None
              else u.copy())
    return FormResult(beta=beta, pf=float(_phi(np.array(-beta))),
                      u_star=u, x_star=x_star, alpha=alpha,
                      g_star=g_u, n_iter=it, n_evals=n_evals,
                      converged=converged)


def sorm_correction(g: Callable[[np.ndarray], float], res: FormResult,
                    fd_step: float = 0.05) -> float:
    """Second-order (SORM, Breitung) failure probability at the FORM
    design point: pf = Phi(-beta) * prod_i 1/sqrt(1 + beta * kappa_i).

    The limit-state surface's principal curvatures at u* are taken from a
    central-difference Hessian in u-space, projected onto the tangent
    plane of alpha and normalized by |grad g|.  Exact for parabolic
    surfaces (tested); for the environmental limit states here the
    correction quantifies how conservative/optimistic the first-order
    pf is against the curved response surface.
    """
    u = res.u_star
    n = u.size
    if not np.isfinite(res.beta):
        raise ValueError("SORM needs a converged FORM result")
    # central-difference Hessian (symmetrized)
    H = np.zeros((n, n))
    g0 = float(g(u))
    for i in range(n):
        ei = np.zeros(n)
        ei[i] = fd_step
        H[i, i] = (g(u + ei) - 2.0 * g0 + g(u - ei)) / fd_step**2
        for j in range(i + 1, n):
            ej = np.zeros(n)
            ej[j] = fd_step
            H[i, j] = H[j, i] = (
                g(u + ei + ej) - g(u + ei - ej)
                - g(u - ei + ej) + g(u - ei - ej)) / (4.0 * fd_step**2)
    gn = abs(float(_fd_grad(g, u, fd_step) @ res.alpha))  # |grad| along -alpha
    if gn < 1e-300:
        raise ValueError("flat limit state at the design point")
    # tangent-plane basis: QR of [alpha | I] puts +/-alpha in column 0 and
    # an orthonormal completion in columns 1..n-1
    q, _ = np.linalg.qr(np.column_stack([res.alpha, np.eye(n)]))
    t_basis = q[:, 1:n]
    A = t_basis.T @ H @ t_basis / gn
    kappa = np.linalg.eigvalsh(0.5 * (A + A.T))
    factor = 1.0 + res.beta * kappa
    if (factor <= 0).any():
        raise ValueError("Breitung correction undefined: beta * kappa <= -1 "
                         "(surface curves back around the origin)")
    return float(res.pf / np.sqrt(np.prod(factor)))


def importance_sample(g: Callable[[np.ndarray], float], res: FormResult,
                      n_samples: int = 2000, seed: int = 0,
                      ) -> tuple[float, float]:
    """Unbiased Monte-Carlo check of the FORM result: (pf, cov).

    Standard-normal importance sampling centered at the design point —
    the estimator pf = E[1{g<0} phi(u)/phi(u - u*)] is exact for ANY
    limit-state shape, with the design-point centering keeping the
    variance usable at small pf (plain MC would need ~10/pf samples).
    Returns the estimate and its coefficient of variation.
    """
    if n_samples < 2:
        raise ValueError("importance_sample needs n_samples >= 2 (the cov "
                         "estimate uses ddof=1)")
    rng = np.random.default_rng(seed)
    n = res.u_star.size
    z = rng.standard_normal((n_samples, n))
    u = z + res.u_star
    # weight phi(u)/phi(z) = exp(-u*.u + 0.5|u*|^2) evaluated stably in log
    logw = -u @ res.u_star + 0.5 * float(res.u_star @ res.u_star)
    fail = np.fromiter((float(g(ui)) < 0.0 for ui in u), dtype=bool,
                       count=n_samples)
    # exponentiate ONLY failing samples: samples far opposite u* carry
    # logw ~ +|z||u*| and would overflow to inf before the mask zeroed them
    w = np.zeros(n_samples)
    w[fail] = np.exp(logw[fail])
    pf = float(w.mean())
    if pf <= 0.0:
        return 0.0, np.inf
    cov = float(w.std(ddof=1) / (np.sqrt(n_samples) * pf))
    return pf, cov


def importance_sample_batch(g_batch: Callable[[np.ndarray], np.ndarray],
                            res: FormResult, n_samples: int = 1024,
                            seed: int = 0) -> tuple[float, float]:
    """:func:`importance_sample` with ALL samples evaluated in one call.

    ``g_batch(U) -> g[n]`` takes the whole [n_samples, n_dim] standard-
    normal batch — pair it with :func:`hs_tp_limit_state_batch`, whose
    pipeline evaluation is ONE jitted design-envelope program (optionally
    sharded over a device mesh), so a 1,000-sample Monte-Carlo check costs
    about as much as one storm envelope instead of 1,000 phase scans.
    Same estimator and seed convention as the scalar version (identical
    samples, tested identity).
    """
    if n_samples < 2:
        raise ValueError("importance_sample_batch needs n_samples >= 2 (the "
                         "cov estimate uses ddof=1)")
    rng = np.random.default_rng(seed)
    n = res.u_star.size
    z = rng.standard_normal((n_samples, n))
    u = z + res.u_star
    logw = -u @ res.u_star + 0.5 * float(res.u_star @ res.u_star)
    gv = np.asarray(g_batch(u), np.float64)
    if gv.shape != (n_samples,):
        raise ValueError(f"g_batch must return [{n_samples}] values, got "
                         f"shape {gv.shape}")
    fail = gv < 0.0
    w = np.zeros(n_samples)
    w[fail] = np.exp(logw[fail])
    pf = float(w.mean())
    if pf <= 0.0:
        return 0.0, np.inf
    cov = float(w.std(ddof=1) / (np.sqrt(n_samples) * pf))
    return pf, cov


def hs_tp_limit_state_batch(response_batch, joint: JointHsTp,
                            threshold: float):
    """Batched counterpart of :func:`hs_tp_limit_state`:
    ``g_batch(U[n, 2]) -> threshold - response_batch(hs[n], tp[n])``."""

    def g_batch(U):
        U = np.asarray(U, np.float64)
        hs, tp = rosenblatt_hs_tp(joint, U[:, 0], U[:, 1])
        return threshold - np.asarray(response_batch(hs, tp), np.float64)

    return g_batch


def utilization_response_batch(model, case, d: float, U_c: float = 0.0,
                               wave_model: str = "airy", N: int = 5,
                               n_steps: int = 24, h_min: float = 0.05,
                               h_max: float | None = None, mesh=None):
    """``response_batch(hs[n], tp[n]) -> max utilization [n]`` as ONE
    device program — the batched Monte-Carlo path.

    The whole sample batch becomes a wave-case batch through the existing
    storm-envelope machinery (`api.design_envelope`): stiffness factored
    once, all cases x phases in one multi-RHS solve, and with ``mesh`` (1-D
    device mesh, axis 'cases') the samples shard across chips with the
    governing reduction across devices.  Clipping semantics match
    :func:`utilization_response`.
    """
    from ..api import design_envelope
    from ..parallel.sweep import make_case_batch, make_wave_batch

    cap = 0.75 * d if h_max is None else h_max

    def response_batch(hs, tp):
        hs, tp = _breaking_clip(hs, tp, d, h_min, cap)
        waves = make_wave_batch(hs, tp, d, U_c=U_c, model=wave_model, N=N,
                                dtype=model.coords.dtype)
        cases = make_case_batch(case, t_analysis=np.zeros(hs.size))
        env = design_envelope(model, waves, cases, n_steps=n_steps,
                              mesh=mesh)
        return np.asarray(env.max_util_per_case)

    return response_batch


def bivariate_normal_cdf(a: float, b: float, rho: float) -> float:
    """P(X <= a, Y <= b) for standard bivariate normal with correlation
    rho, by the classical 1-D reduction
    integral_{-inf}^{a} phi(x) Phi((b - rho x)/sqrt(1 - rho^2)) dx
    on a composite-Simpson grid (|error| < 1e-9, tested vs independence/
    comonotone identities and Monte Carlo)."""
    rho = float(np.clip(rho, -1.0, 1.0))
    if rho >= 1.0 - 1e-12:
        return float(_phi(np.array(min(a, b))))
    if rho <= -1.0 + 1e-12:
        return float(max(0.0, _phi(np.array(a)) + _phi(np.array(b)) - 1.0))
    lo = min(-10.0, a - 1.0)
    x = np.linspace(lo, a, 4001)
    pdf = np.exp(-0.5 * x * x) / np.sqrt(2.0 * np.pi)
    inner = _phi((b - rho * x) / np.sqrt(1.0 - rho * rho))
    f = pdf * inner
    h = x[1] - x[0]
    # composite Simpson (n points odd): h/3 * (f0 + 4 f_odd + 2 f_even + fn)
    return float(h / 3.0 * (f[0] + f[-1] + 4.0 * f[1:-1:2].sum()
                            + 2.0 * f[2:-1:2].sum()))


class SystemReliability(NamedTuple):
    """Ditlevsen (second-order series-system) bounds on the system pf."""

    p_lower: float          # lower bound on P(any component fails)
    p_upper: float          # upper bound
    pf_components: np.ndarray  # [K] component probabilities (as ordered in)
    rho: np.ndarray         # [K, K] alpha correlations
    order: np.ndarray       # [K] evaluation order (decreasing pf)


def ditlevsen_bounds(betas, alphas) -> SystemReliability:
    """Second-order series-system bounds from component FORM results.

    ``betas`` [K] and unit ``alphas`` [K, n]: each component's reliability
    index and direction.  Pairwise joint failure probabilities use the
    FORM-linearized components P(Z_i > beta_i, Z_j > beta_j) with
    correlation rho_ij = alpha_i . alpha_j (the standard recipe); the
    bounds are exact for two components and bracket the series pf tightly
    when components are ranked by decreasing probability (done here).
    Infinite betas (unreachable components) are skipped.
    """
    betas = np.asarray(betas, np.float64)
    alphas = np.asarray(alphas, np.float64)
    keep = np.isfinite(betas)
    b = betas[keep]
    al = alphas[keep]
    if b.size == 0:
        z = np.zeros((0,))
        return SystemReliability(0.0, 0.0, z, np.zeros((0, 0)),
                                 z.astype(int))
    p = np.asarray(_phi(-b), np.float64)
    order = np.argsort(-p)
    b, al, p = b[order], al[order], p[order]
    K = b.size
    rho = np.clip(al @ al.T, -1.0, 1.0)
    pij = np.zeros((K, K))
    for i in range(K):
        for j in range(i):
            pij[i, j] = bivariate_normal_cdf(-b[i], -b[j], rho[i, j])
    lower = p[0]
    upper = p[0]
    for i in range(1, K):
        lower += max(0.0, p[i] - pij[i, :i].sum())
        upper += p[i] - pij[i, :i].max()
    # a valid probability and ordering even with quadrature round-off
    upper = min(max(upper, lower), 1.0)
    return SystemReliability(float(lower), float(upper), p, rho,
                             np.where(keep)[0][order])


class MemberReliability(NamedTuple):
    """Component FORM over every member + series-system bounds."""

    beta: np.ndarray        # [M] per-member reliability index (inf if the
                            #   member cannot reach the threshold)
    pf: np.ndarray          # [M] per-member failure probability per state
    alpha: np.ndarray       # [M, 2] sensitivity directions
    hs_star: np.ndarray     # [M] per-member design storm
    tp_star: np.ndarray     # [M]
    converged: np.ndarray   # [M] bool
    reachable: np.ndarray   # [M] bool (threshold crossable inside the
                            #   searched radius)
    system: SystemReliability
    n_envelopes: int        # device programs spent on the whole search


def member_reliability(member_response_batch, joint: JointHsTp,
                       threshold: float, u0=None, tol: float = 5e-3,
                       max_iter: int = 20, fd_step: float = 0.05,
                       search_radius: float = 8.0) -> MemberReliability:
    """Component FORM for EVERY member simultaneously + Ditlevsen system
    bounds — the series-system view of `environmental_reliability`.

    ``member_response_batch(hs[n], tp[n]) -> util[n, M]`` returns every
    member's utilization for a whole sea-state batch (see
    :func:`member_utilization_response_batch`): each iteration advances
    ALL M simultaneous HL-RF searches with TWO device programs (one for
    values+gradients, one for the step candidates), instead of M separate
    scalar searches.  Members whose utilization stays below the threshold
    even at ``search_radius`` (pf < ~6e-16) are reported unreachable with
    beta = inf and excluded from the system bounds.
    """
    def g_at(U):
        """U [n, 2] -> per-member limit state g [n, M]."""
        hs, tp = rosenblatt_hs_tp(joint, U[:, 0], U[:, 1])
        return threshold - np.asarray(member_response_batch(hs, tp),
                                      np.float64)

    # reachability pre-screen over SEVERAL points of the search circle, not
    # just the pure-Hs extreme: a member whose utilization peaks off the Hs
    # axis (Tp-driven, e.g. near a cancellation period) is reachable on the
    # disk even though the (r, 0) point is safe.  One batched envelope call.
    theta = np.array([-0.6, -0.3, 0.0, 0.3, 0.6])
    ring = search_radius * np.column_stack([np.cos(theta), np.sin(theta)])
    g_ring = g_at(ring)                       # [n_theta, M]
    g_cap = g_ring.min(axis=0)
    M = g_cap.size
    reachable = g_cap < 0.0
    idx = np.where(reachable)[0]
    n_env = 1

    if u0 is None:
        # per-member start direction: toward the ring point where that
        # member's limit state is deepest, so Tp-driven members (reachable
        # only off the Hs axis) begin their HL-RF search in the right sector
        U = np.column_stack([np.cos(theta), np.sin(theta)])[
            g_ring.argmin(axis=0)]
    else:
        U = np.tile(np.asarray(u0, np.float64), (M, 1))
    g_u = np.full(M, np.nan)
    grad = np.zeros((M, 2))
    conv = np.zeros(M, bool)
    K = idx.size
    if K and u0 is None:
        # Land each search ON the limit-state surface first by bisecting
        # g(t * e) along the member's deepest ray, t in [0, R].  HL-RF from
        # a surface point is stable even for members whose limit state goes
        # flat near the Hs cap (where a norm-1 start makes gc/|grad| blow
        # up); one batched program per bisection step.
        e = U[idx]
        lo = np.zeros(K)
        hi = np.full(K, search_radius)
        for _ in range(10):
            mid = 0.5 * (lo + hi)
            gm = g_at(mid[:, None] * e)[np.arange(K), idx]
            n_env += 1
            neg = gm < 0.0
            hi = np.where(neg, mid, hi)
            lo = np.where(neg, lo, mid)
        U[idx] = (0.5 * (lo + hi))[:, None] * e
    if K:
        g_scale = None
        # best ON-SURFACE iterate per member: a max-over-phases limit state
        # is only piecewise-smooth, so plain HL-RF can limit-cycle around a
        # kinked design point with beta already stable to ~1e-3.  We keep
        # the minimum-norm iterate whose |g| is small (i.e. genuinely on
        # the surface — merit values are NOT comparable across iterations
        # because the penalty weight and |grad| change) and accept it once
        # three iterations bring no improvement (standard iHL-RF practice
        # for non-smooth g).
        best_n = np.full(K, np.inf)
        best_U = U[idx].copy()
        best_grad = np.zeros((K, 2))
        best_g = np.full(K, np.nan)
        stall = np.zeros(K, int)
        for _ in range(max_iter):
            # one program: center + 4 central-difference points, all members
            Ui = U[idx]
            pts = np.concatenate([
                Ui,
                Ui + [fd_step, 0.0], Ui - [fd_step, 0.0],
                Ui + [0.0, fd_step], Ui - [0.0, fd_step]])
            vals = g_at(pts)[:, idx]              # [5K, K]
            diag = np.arange(K)
            gc = vals[:K][diag, diag]
            gx = (vals[K:2 * K][diag, diag]
                  - vals[2 * K:3 * K][diag, diag]) / (2 * fd_step)
            gy = (vals[3 * K:4 * K][diag, diag]
                  - vals[4 * K:5 * K][diag, diag]) / (2 * fd_step)
            n_env += 1
            g_u[idx], grad[idx, 0], grad[idx, 1] = gc, gx, gy
            if g_scale is None:
                g_scale = np.maximum(1.0, np.abs(gc))
            gn = np.hypot(gx, gy)
            gn_safe = np.maximum(gn, 1e-300)
            al = -np.stack([gx, gy], 1) / gn_safe[:, None]
            upar = np.einsum("kj,kj->k", al, Ui)
            ortho = np.linalg.norm(Ui - upar[:, None] * al, axis=1)
            # track the minimum-norm on-surface iterate
            C = np.maximum(2.0 * np.abs(upar), 2.0)
            u_norm = np.linalg.norm(Ui, axis=1)
            on_surface = np.abs(gc) < 10.0 * tol * g_scale
            better = on_surface & (u_norm < best_n - 1e-3)
            best_n = np.where(better, u_norm, best_n)
            best_U[better] = Ui[better]
            best_grad[better, 0] = gx[better]
            best_grad[better, 1] = gy[better]
            best_g = np.where(better, gc, best_g)
            stall = np.where(better, 0, stall + 1)
            strict = ((np.abs(gc) < tol * g_scale)
                      & (ortho < tol * np.maximum(1.0, np.abs(upar))))
            # stagnation acceptance: an on-surface iterate exists and three
            # iterations brought no shorter one
            stalled = (stall >= 3) & np.isfinite(best_n)
            done = strict | stalled
            conv[idx] = conv[idx] | done
            live = ~done & (gn > 1e-300)
            if not live.any():
                break
            # HL-RF target + merit-minimizing candidates, one program
            Unew = (upar + gc / gn_safe)[:, None] * al
            D = Unew - Ui
            lams = (1.0, 0.5, 0.25)
            cand = np.concatenate([Ui + lam * D for lam in lams])
            cv = g_at(cand)[:, idx]               # [3K, K]
            n_env += 1
            merits = np.stack(
                [0.5 * np.einsum("kj,kj->k", Ui + lam * D, Ui + lam * D)
                 + C * np.abs(cv[i * K:(i + 1) * K][diag, diag]) / gn_safe
                 for i, lam in enumerate(lams)])   # [3, K]
            pick = np.argmin(merits, axis=0)
            stepped = Ui + np.asarray(lams)[pick][:, None] * D
            # the design point lies inside the search disk by construction
            # (reachability means g < 0 somewhere at radius R, so the
            # minimum-norm crossing is at most R); clamp runaway iterates
            nrm = np.linalg.norm(stepped, axis=1)
            scale = np.minimum(1.0, search_radius / np.maximum(nrm, 1e-300))
            stepped = stepped * scale[:, None]
            U[idx[live]] = stepped[live]
        # report the best recorded surface point, not the last iterate
        settled = np.isfinite(best_n)
        U[idx[settled]] = best_U[settled]
        grad[idx[settled]] = best_grad[settled]
        g_u[idx[settled]] = best_g[settled]

    # beta is the DISTANCE to the design point.  At smooth converged points
    # alpha @ U == |U| to within tol, but at kinked design points (max-over-
    # phases responses) the accepted iterate is not gradient-parallel and
    # the projection would understate beta badly; |U| is the FORM definition
    # either way.  alpha likewise from the design-point direction, with the
    # gradient direction only as a fallback for degenerate |U| = 0.
    unorm = np.linalg.norm(U, axis=1)
    gn = np.linalg.norm(grad, axis=1)
    alpha_grad = np.where(gn[:, None] > 0,
                          -grad / np.maximum(gn, 1e-300)[:, None], 0.0)
    alpha = np.where(unorm[:, None] > 1e-12,
                     U / np.maximum(unorm, 1e-300)[:, None], alpha_grad)
    beta = np.where(reachable, unorm, np.inf)
    hs_star, tp_star = rosenblatt_hs_tp(joint, U[:, 0], U[:, 1])
    pf = np.where(np.isfinite(beta), np.asarray(_phi(-beta)), 0.0)
    use = reachable & conv
    system = ditlevsen_bounds(np.where(use, beta, np.inf), alpha)
    return MemberReliability(beta=beta, pf=pf, alpha=alpha,
                             hs_star=np.asarray(hs_star),
                             tp_star=np.asarray(tp_star),
                             converged=conv, reachable=reachable,
                             system=system, n_envelopes=n_env)


def member_utilization_response_batch(model, case, d: float,
                                      U_c: float = 0.0,
                                      wave_model: str = "airy", N: int = 5,
                                      n_steps: int = 24,
                                      h_min: float = 0.05,
                                      h_max: float | None = None,
                                      mesh=None):
    """``(hs[n], tp[n]) -> per-member max utilization [n, M]`` as one
    design-envelope program (the phase axis reduced on device) — feeds
    :func:`member_reliability`."""
    from ..api import design_envelope
    from ..parallel.sweep import make_case_batch, make_wave_batch

    cap = 0.75 * d if h_max is None else h_max

    def response_batch(hs, tp):
        hs, tp = _breaking_clip(hs, tp, d, h_min, cap)
        waves = make_wave_batch(hs, tp, d, U_c=U_c, model=wave_model, N=N,
                                dtype=model.coords.dtype)
        cases = make_case_batch(case, t_analysis=np.zeros(hs.size))
        env = design_envelope(model, waves, cases, n_steps=n_steps,
                              mesh=mesh)
        return np.asarray(env.utilization).max(axis=1)   # [n, M]

    return response_batch


class EnvironmentalReliability(NamedTuple):
    """FORM result annualized against the sea-state climate."""

    form: FormResult
    hs_star: float            # design-point significant/design wave height
    tp_star: float            # design-point period
    pf_state: float           # failure probability per sea state
    pf_annual: float          # 1 - (1 - pf_state)^(states per year)
    return_years: float       # implied return period of the failure event


def hs_tp_limit_state(response: Callable[[float, float], float],
                      joint: JointHsTp, threshold: float):
    """(g_of_u, x_of_u) closures for a response threshold under the joint
    (Hs, Tp) model — the limit state fed to :func:`form`.

    ``response(hs, tp) -> scalar`` is any monotone-cost response measure
    (max utilization, base shear, deck displacement...); failure is
    response > threshold.  The Rosenblatt transform is EXACTLY the one the
    IFORM contour uses (`ops/metocean.py::rosenblatt_hs_tp`).
    """

    def x_of_u(u):
        hs, tp = rosenblatt_hs_tp(joint, u[0], u[1])
        return np.array([float(hs), float(tp)])

    def g_of_u(u):
        hs, tp = x_of_u(u)
        return threshold - float(response(hs, tp))

    return g_of_u, x_of_u


def environmental_reliability(response: Callable[[float, float], float],
                              joint: JointHsTp, threshold: float,
                              u0: np.ndarray | None = None,
                              tol: float = 5e-3, max_iter: int = 50,
                              fd_step: float = 0.05,
                              search_radius: float = 8.0,
                              ) -> EnvironmentalReliability:
    """Direct FORM on ``response(Hs, Tp) > threshold`` under the fitted
    climate: reliability index, per-state and annual failure probability,
    and the most-probable failure sea state.

    Without an explicit ``u0`` the search is primed like
    :func:`member_reliability`: the limit state is screened on an arc of
    the ``search_radius`` circle (pf beyond it < ~6e-16); if the threshold
    is unreachable there the result reports beta = inf / pf = 0 instead of
    a failed HL-RF, and otherwise a bisection along the deepest arc ray
    puts the start ON the limit-state surface, where iHL-RF is stable even
    when the breaking-saturated response has flat far-field plateaus.

    Defaults are looser than the generic :func:`form`: the Morison load is
    integrated with fixed Gauss points masked by submergence, so the
    response is piecewise-smooth in Hs with ~1e-3-utilization steps where
    the free surface crosses a quadrature point (the reference's dry-point
    zeroing has the same granularity, `JacketAnalysisGUI_v2.py:626-628`).
    A wide secant step (``fd_step = 0.05`` in u-space) reads the slope
    across those steps instead of sampling their jumps, and ``tol = 5e-3``
    (relative to the limit-state scale) accepts the design point at the
    same granularity — tighter tolerances would chase quadrature noise,
    not physics.
    """
    g_of_u, x_of_u = hs_tp_limit_state(response, joint, threshold)
    n_pre = 0
    if u0 is None:
        theta = np.array([-0.6, -0.3, 0.0, 0.3, 0.6])
        dirs = np.column_stack([np.cos(theta), np.sin(theta)])
        g_ring = np.array([g_of_u(search_radius * e) for e in dirs])
        n_pre += dirs.shape[0]
        if not (g_ring < 0.0).any():
            # threshold unreachable inside the searched disk: the climate
            # cannot produce the response even at the breaking-saturated
            # extreme; report pf ~ 0 rather than a failed HL-RF
            i = int(np.argmin(g_ring))
            u_far = search_radius * dirs[i]
            x_far = np.asarray(x_of_u(u_far), np.float64)
            res = FormResult(beta=np.inf, pf=0.0, u_star=u_far, x_star=x_far,
                             alpha=dirs[i].copy(), g_star=float(g_ring[i]),
                             n_iter=0, n_evals=n_pre, converged=True)
            return EnvironmentalReliability(
                form=res, hs_star=float(x_far[0]), tp_star=float(x_far[1]),
                pf_state=0.0, pf_annual=0.0, return_years=np.inf)
        e = dirs[int(np.argmin(g_ring))]
        lo, hi = 0.0, search_radius
        for _ in range(10):
            mid = 0.5 * (lo + hi)
            if g_of_u(mid * e) < 0.0:
                hi = mid
            else:
                lo = mid
            n_pre += 1
        u0 = 0.5 * (lo + hi) * e
    res = form(g_of_u, 2, x_of_u=x_of_u, u0=u0, tol=tol,
               max_iter=max_iter, fd_step=fd_step)
    res = res._replace(n_evals=res.n_evals + n_pre)
    states_per_year = 8766.0 / joint.state_hours
    pf_state = res.pf
    # exact complement product; log1p keeps the tiny-pf regime accurate
    pf_annual = float(-np.expm1(states_per_year * np.log1p(-min(pf_state,
                                                                1 - 1e-16))))
    ret = (np.inf if pf_state <= 0.0
           else joint.state_hours / (8766.0 * pf_state))
    return EnvironmentalReliability(
        form=res, hs_star=float(res.x_star[0]), tp_star=float(res.x_star[1]),
        pf_state=pf_state, pf_annual=pf_annual, return_years=float(ret))


def utilization_response(model, case, d: float, U_c: float = 0.0,
                         wave_model: str = "airy", N: int = 5,
                         n_steps: int = 24, h_min: float = 0.05,
                         h_max: float | None = None):
    """``response(hs, tp) -> max phase-scan utilization`` closure for
    :func:`environmental_reliability` on the full pipeline.

    Each call builds the wave for (H=hs, T=tp) — same deterministic
    design-wave convention as the IFORM envelope recipe
    (`ops/metocean.py::n_year_sea_states`) — and runs one jitted
    ``analyze_phase_batch``; repeated calls hit the jit cache (shapes are
    static).  (Hs, Tp) probes are clamped to physically realizable waves —
    H to [h_min, min(h_max, Miche breaking height)] (h_max default 0.75 d)
    and Tp to [2, 30] s via :func:`_breaking_clip` — so the limit state
    stays defined in the far Gaussian tail, where the response saturates
    physically at the breaking limit.
    """
    from ..api import analyze_phase_batch
    from .wave_models import make_wave

    cap = 0.75 * d if h_max is None else h_max

    def response(hs: float, tp: float) -> float:
        h, tp = _breaking_clip(hs, tp, d, h_min, cap)
        wave = make_wave(float(h), float(tp), d, U_c=U_c, model=wave_model,
                         N=N)
        _, batch = analyze_phase_batch(model, wave, case, n_steps=n_steps)
        return float(np.max(np.asarray(batch.utilization)))

    return response
