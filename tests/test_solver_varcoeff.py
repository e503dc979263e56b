"""Variable-coefficient / delta-tracking tests (config #4).

Asserting rebuilds of ``tests/testWoStCorrectness.py`` (polynomial
manufactured solution, ``:81-142``) plus analytic screened-Poisson checks
the reference does not have.
"""

import numpy as np
import scipy.special as sp

from dcrmontecarlo_tpu import Problem, WoStSolver, square_loop, circle_loop
from dcrmontecarlo_tpu.solver import SolverOptions


def test_screened_constant_sigma_disk():
    # -lap u + sigma u = 0 on unit disk, u = 1 on the boundary:
    # u(x) = I0(|x| sqrt(sigma)) / I0(sqrt(sigma)).
    sigma = 4.0
    prob = Problem(
        dirichlet=circle_loop(1.0, n=256),
        bc_dirichlet=lambda x, y: 1.0 + 0.0 * x,
        sigma=lambda x, y: sigma + 0.0 * x,
        # constant sigma' -> grid spread 0 -> reference fallback sigma_bar=10
        # (WoStSolver.py:134-136) exercises delta tracking with a loose
        # majorant; the estimator stays unbiased.
    )
    assert prob.use_delta_tracking
    solver = WoStSolver(prob, SolverOptions(target_slots=16384))
    pts = np.array([[0.0, 0.0], [0.5, 0.0], [0.0, 0.8]])
    res = solver.solve(pts, n_walks=8000, max_steps=1000, eps=1e-3, seed=0)
    r = np.sqrt(pts[:, 0] ** 2 + pts[:, 1] ** 2)
    exact = sp.i0(r * np.sqrt(sigma)) / sp.i0(np.sqrt(sigma))
    err = np.abs(res.mean - exact)
    tol = 4.0 * res.stderr + 0.01
    assert (err < tol).all(), (res.mean, exact, res.stderr)


def test_constant_alpha_reduces_to_wos():
    # alpha = 5 constant, sigma = 0: PDE is 5 lap u = -f. With f = 0 and
    # harmonic BC the solution equals the plain-WoS one.
    prob = Problem(
        dirichlet=square_loop(1.0),
        bc_dirichlet=lambda x, y: x + 2.0 * y,
        alpha=lambda x, y: 5.0 + 0.0 * x,
    )
    assert prob.use_delta_tracking
    solver = WoStSolver(prob, SolverOptions(target_slots=8192))
    pts = np.array([[0.0, 0.0], [0.4, -0.2]])
    res = solver.solve(pts, n_walks=6000, max_steps=1000, eps=1e-3, seed=1)
    exact = pts[:, 0] + 2.0 * pts[:, 1]
    err = np.abs(res.mean - exact)
    tol = 4.0 * res.stderr + 0.01
    assert (err < tol).all(), (res.mean, exact, res.stderr)


def _polynomial_manufactured():
    """Reference manufactured solution (testWoStCorrectness.py:81-142):
    u = (1-x^2)(1-y^2), D = 2 + 0.5x + 0.5y, absorption = 2 + xy,
    f = -div(D grad u) + sigma u derived analytically.
    """

    def u_exact(pts):
        x, y = pts[:, 0], pts[:, 1]
        return (1 - x**2) * (1 - y**2)

    def alpha(x, y):
        return 2.0 + 0.5 * x + 0.5 * y

    def sigma(x, y):
        return 2.0 + x * y

    def bc(x, y):
        return (1 - x * x) * (1 - y * y)

    def source(x, y):
        u = (1 - x * x) * (1 - y * y)
        lap_u = -2 * (2 - x * x - y * y)
        D = 2 + 0.5 * x + 0.5 * y
        gradD_dot_gradu = -x * (1 - y * y) - y * (1 - x * x)
        div_D_grad_u = D * lap_u + gradD_dot_gradu
        return -div_D_grad_u + (2 + x * y) * u

    return u_exact, alpha, sigma, bc, source


def test_manufactured_polynomial_solution():
    u_exact, alpha, sigma, bc, source = _polynomial_manufactured()
    prob = Problem(
        dirichlet=square_loop(1.0),
        bc_dirichlet=bc,
        source=source,
        alpha=alpha,
        sigma=sigma,
    )
    assert prob.use_delta_tracking
    assert prob.sigma_bar > 0
    solver = WoStSolver(prob, SolverOptions(target_slots=16384))
    # interior grid like create_test_points (testWoStCorrectness.py:144-156)
    g = np.linspace(-0.7, 0.7, 4)
    X, Y = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    res = solver.solve(pts, n_walks=3000, max_steps=800, eps=1e-3, seed=2)
    exact = u_exact(pts)
    err = np.abs(res.mean - exact)
    tol = 5.0 * res.stderr + 0.03
    frac_ok = (err < tol).mean()
    rmse = np.sqrt(np.mean((res.mean - exact) ** 2))
    assert rmse < 0.08, (rmse, res.mean, exact)
    assert frac_ok > 0.85, (frac_ok, err, tol)


def test_transport_sampler_solution_unbiased():
    # screened_sampler="transport" (map + exact IS weight) must reproduce
    # the manufactured solution with the same gates as the rejection
    # default — the weight contract makes it exactly unbiased, and the
    # fitted map only controls the (tiny) weight spread
    u_exact, alpha, sigma, bc, source = _polynomial_manufactured()
    prob = Problem(
        dirichlet=square_loop(1.0),
        bc_dirichlet=bc,
        source=source,
        alpha=alpha,
        sigma=sigma,
    )
    solver = WoStSolver(
        prob, SolverOptions(target_slots=16384, screened_sampler="transport")
    )
    g = np.linspace(-0.7, 0.7, 4)
    X, Y = np.meshgrid(g, g, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)
    res = solver.solve(pts, n_walks=3000, max_steps=800, eps=1e-3, seed=2)
    exact = u_exact(pts)
    err = np.abs(res.mean - exact)
    tol = 5.0 * res.stderr + 0.03
    rmse = np.sqrt(np.mean((res.mean - exact) ** 2))
    assert rmse < 0.08, (rmse, res.mean, exact)
    assert (err < tol).mean() > 0.85, (err, tol)


def test_convergence_with_walks():
    # RMSE must drop as n_walks grows (reference convergence sweep,
    # testWoStCorrectness.py:185-196).
    u_exact, alpha, sigma, bc, source = _polynomial_manufactured()
    prob = Problem(
        dirichlet=square_loop(1.0), bc_dirichlet=bc, source=source,
        alpha=alpha, sigma=sigma,
    )
    solver = WoStSolver(prob, SolverOptions(target_slots=8192))
    pts = np.array([[0.0, 0.0], [0.3, -0.3], [-0.5, 0.2]])
    exact = u_exact(pts)
    rmses = []
    for n_walks in [50, 400, 3200]:
        res = solver.solve(pts, n_walks=n_walks, max_steps=800, eps=1e-3, seed=3)
        rmses.append(np.sqrt(np.mean((res.mean - exact) ** 2)))
    assert rmses[2] < rmses[0], rmses


def test_neumann_coefficient_gradient_robin():
    # alpha = exp(k y) has a strong coefficient gradient AT the Neumann
    # surface, where the sqrt-alpha transform turns zero-flux u into a
    # Robin condition for u~. The exact solution is u = x / 5 (separable:
    # (alpha v')' = 0 with v'(0) = 0 forces v = const). Gates:
    # (a) walks stay finite (the reference's walkers tunnel out and blow
    #     up on this field),
    # (b) the FULL Robin correction (wall-arrival weight + on-boundary
    #     chord branch, robin_correction=True) is UNBIASED: 4-sigma
    #     agreement with the analytic solution,
    # (c) plain reflection (default) has the documented bias, which the
    #     correction removes.
    import jax.numpy as jnp

    from dcrmontecarlo_tpu.geometry import Polyline

    k = 0.5
    alpha = lambda x, y: jnp.exp(k * y) + 0.0 * x
    prob = Problem(
        dirichlet=Polyline.from_points(
            [[-5.0, 0.0], [-5.0, -10.0], [5.0, -10.0], [5.0, 0.0]]
        ),
        neumann=Polyline.from_points([[-5.0, 0.0], [5.0, 0.0]]),
        bc_dirichlet=lambda x, y: x / 5.0,
        alpha=alpha,
    )
    pts = np.stack([np.linspace(-4, 4, 5, dtype=np.float32),
                    np.full(5, -0.05, np.float32)], 1)
    exact = pts[:, 0] / 5.0
    res = {}
    for robin in (False, "chain", "reflectance"):
        s = WoStSolver(prob, SolverOptions(target_slots=65536,
                                           backend="xla",
                                           robin_correction=robin))
        res[robin] = s.solve(pts, n_walks=12000, max_steps=4000, eps=0.02,
                             seed=1)
        assert np.isfinite(res[robin].mean).all(), res[robin].mean
    sel = np.abs(exact) > 0.1
    err_plain = np.abs(res[False].mean - exact)[sel].sum()
    for mode in ("chain", "reflectance"):
        r = res[mode]
        dev = np.abs(r.mean - exact) / np.maximum(r.stderr, 1e-12)
        assert (dev < 4.0).all(), (mode, r.mean, exact, r.stderr, dev)
        err_robin = np.abs(r.mean - exact)[sel].sum()
        assert err_robin < err_plain, (mode, err_robin, err_plain)


def test_robin_auto_policy():
    # "auto" compares the probed correction scale gamma_max * min(diam,
    # 1/sqrt(sigma_bar)) against 0.05 (re-tuned 2026-08-18 from the
    # control measurement: at the flagship's s = 0.119 the chain's
    # absolute-potential bias is ~3x smaller than plain reflection's,
    # THEORY.md §4f): the exp(k y) stress field (scale 1.0, 40%
    # plain-reflection bias) resolves to the strictly unbiased "chain"
    # realization, a buried-bump conductivity with ~zero surface gamma
    # stays off (wall visits too rare for bias or tail to matter), and
    # explicit False / True ("chain") / "reflectance" override.
    import jax.numpy as jnp

    from dcrmontecarlo_tpu.geometry import Polyline
    from dcrmontecarlo_tpu.problems.fields import gaussian_bump

    dirichlet = Polyline.from_points(
        [[-5.0, 0.0], [-5.0, -10.0], [5.0, -10.0], [5.0, 0.0]]
    )
    neumann = Polyline.from_points([[-5.0, 0.0], [5.0, 0.0]])

    strong = Problem(
        dirichlet=dirichlet, neumann=neumann,
        bc_dirichlet=lambda x, y: x / 5.0,
        alpha=lambda x, y: jnp.exp(0.5 * y) + 0.0 * x,
    )
    bump = gaussian_bump(center=(0.0, -6.0), amplitude=9.0, width=1.0)
    buried = Problem(
        dirichlet=dirichlet, neumann=neumann,
        bc_dirichlet=lambda x, y: 0.0 * x,
        alpha=lambda x, y: 1.0 + bump(x, y),
    )
    assert WoStSolver(strong)._robin_enabled() == "chain"
    assert WoStSolver(buried)._robin_enabled() is False
    assert WoStSolver(
        strong, SolverOptions(robin_correction=False))._robin_enabled() is False
    assert WoStSolver(
        buried, SolverOptions(robin_correction=True))._robin_enabled() == "chain"
    assert WoStSolver(
        buried, SolverOptions(robin_correction="reflectance"),
    )._robin_enabled() == "reflectance"


def test_roulette_unbiased_and_saves_steps():
    # Russian roulette on an absorbing problem: the estimate must agree
    # with the roulette-off solve (both unbiased; 4-sigma of the combined
    # stderr) while executing materially fewer walker-steps.
    import jax.numpy as jnp

    from dcrmontecarlo_tpu.geometry import square_loop

    sigma = lambda x, y: 2.0 * jnp.exp(-(x * x + y * y) / 0.8)
    prob = Problem(
        dirichlet=square_loop(2.0),
        bc_dirichlet=lambda x, y: 1.0 + 0.0 * x,
        sigma=sigma,
    )
    pts = np.array([[0.0, 0.0], [0.6, -0.4]], np.float32)
    base = WoStSolver(prob, SolverOptions(target_slots=8192)).solve(
        pts, n_walks=4000, max_steps=500, eps=1e-2, seed=11)
    roul = WoStSolver(
        prob, SolverOptions(target_slots=8192, roulette_threshold=0.05)
    ).solve(pts, n_walks=4000, max_steps=500, eps=1e-2, seed=12)
    comb = np.sqrt(base.stderr**2 + roul.stderr**2)
    dev = np.abs(base.mean - roul.mean) / np.maximum(comb, 1e-12)
    assert (dev < 4.0).all(), (base.mean, roul.mean, dev)
    assert roul.total_steps < 0.9 * base.total_steps, (
        roul.total_steps, base.total_steps)


def test_sigma_bar_override_zero_is_safe():
    # sigma_bar_override=0.0 is floored (the screened-kernel norms and the
    # Robin chord sampler divide by sigma_bar); a forced-robin solve on a
    # harmonic-sqrt-alpha field must stay finite, not NaN.
    import jax.numpy as jnp

    from dcrmontecarlo_tpu.geometry import Polyline

    prob = Problem(
        dirichlet=Polyline.from_points(
            [[-2.0, 0.0], [-2.0, -4.0], [2.0, -4.0], [2.0, 0.0]]
        ),
        neumann=Polyline.from_points([[-2.0, 0.0], [2.0, 0.0]]),
        bc_dirichlet=lambda x, y: x / 2.0,
        alpha=lambda x, y: (1.0 - 0.2 * y) ** 2 + 0.0 * x,
        sigma_bar_override=0.0,
    )
    assert prob.sigma_bar > 0
    s = WoStSolver(prob, SolverOptions(target_slots=2048,
                                       robin_correction=True))
    res = s.solve(np.array([[0.0, -0.5]], np.float32), n_walks=300,
                  max_steps=400, eps=1e-2, seed=0)
    assert np.isfinite(res.mean).all() and np.isfinite(res.stderr).all()


def test_xla_split_threshold_unbiased():
    # In-graph high-weight splitting on the XLA backend (the Pallas host
    # loop has its own launch-boundary variant): on a negative-sigma'
    # field whose delta-tracking weights compound above 1, the split-on
    # solve must agree with the split-off solve within combined MC error,
    # actually split (clones add walker-steps), and shrink the heavy-tail
    # stderr.
    import jax.numpy as jnp

    from dcrmontecarlo_tpu.geometry import square_loop

    bump = lambda x, y: 1.0 + 3.0 * jnp.exp(-((x * x + y * y) / 0.18))
    prob = Problem(dirichlet=square_loop(2.0),
                   bc_dirichlet=lambda x, y: 1.0 + x * y, alpha=bump)
    pts = np.array([[0.0, 0.0], [0.4, 0.2]])
    res = {}
    for thr in (None, 1.5):
        s = WoStSolver(prob, SolverOptions(backend="xla", target_slots=2048,
                                           split_threshold=thr))
        res[thr] = s.solve(pts, n_walks=3000, max_steps=200, eps=2e-2,
                           seed=9)
    a, b = res[None], res[1.5]
    comb = np.sqrt(a.stderr**2 + b.stderr**2)
    dev = np.abs(a.mean - b.mean) / np.maximum(comb, 1e-12)
    assert (dev < 4.0).all(), (a.mean, b.mean, dev)
    assert b.total_steps > a.total_steps, (a.total_steps, b.total_steps)
    # The split's claim is HEAVY-TAIL control, asserted robustly: the
    # worst point's stderr and the combined variance must both shrink.
    # (A strict per-point `(b < a).all()` was flaky: the round-5
    # split_reserve default reshuffles slot/stream assignment, and the
    # LIGHT point's stderr is then a different — sometimes larger —
    # realization while the heavy point still improves ~3x.)
    assert b.stderr.max() < a.stderr.max(), (a.stderr, b.stderr)
    assert (b.stderr**2).sum() < 0.7 * (a.stderr**2).sum(), (
        a.stderr, b.stderr)


def test_boundary_snap_removes_near_wall_arrival_bias():
    # THEORY.md 4g: evaluation points a fraction of a mean free path off a
    # Robin (variable-alpha Neumann) wall lose real Robin mass to the
    # grazing-arrival cos(phi) clamp — measured -17 of ~100 on this
    # strongly-screened MMS. boundary_snap starts them ON the wall with
    # the exact on-boundary chord machinery, removing the dominant
    # component (residual ~ -1). Mirrors the reference's interior
    # electrode nudge (testNotebook.ipynb cell 19, y = -0.1), which the
    # snap replaces.
    import jax.numpy as jnp
    from dcrmontecarlo_tpu.geometry import Polyline
    from dcrmontecarlo_tpu.models import autodiff_manufactured

    Lm, c0 = 10.0, 2.0
    w = 0.6 * Lm

    def um(x, y):
        return (100.0 * jnp.sin(jnp.pi * (x + Lm / 2) / Lm)
                * jnp.cos(jnp.pi * y / (2 * Lm)))

    def alpham(x, y):
        return jnp.exp(-c0 * jnp.tanh(-y / w)) + 0.0 * x

    prob, u_ex = autodiff_manufactured(
        um, alpha=alpham,
        dirichlet=Polyline.from_points(
            [[-Lm / 2, 0.0], [-Lm / 2, -Lm], [Lm / 2, -Lm], [Lm / 2, 0.0]]),
        neumann=Polyline.from_points([[-Lm / 2, 0.0], [Lm / 2, 0.0]]))
    # both inside the auto snap tolerance (eps / 2 = 0.01)
    pts = np.array([[0.0, -0.004], [-2.0, -0.008]], np.float32)
    exact = np.asarray(u_ex(pts))

    means = {}
    for tag, snap in (("off", None), ("auto", "auto")):
        s = WoStSolver(prob, SolverOptions(
            backend="xla", target_slots=1 << 14,
            robin_correction="chain", boundary_snap=snap))
        accs = [np.asarray(s.solve(pts, n_walks=4000, max_steps=20000,
                                   eps=0.02, seed=seed).mean)
                for seed in range(4)]
        means[tag] = np.stack(accs)

    bias_on = means["auto"].mean(0) - exact
    sem_on = means["auto"].std(0, ddof=1) / 2.0
    bias_off = means["off"].mean(0) - exact
    # snapped: unbiased within 4 sigma + a small clamp-residual allowance
    assert (np.abs(bias_on) < 4.0 * sem_on + 2.5).all(), (bias_on, sem_on)
    # unsnapped: the clamp bias is large and negative at the first point
    assert bias_off[0] < -8.0, bias_off
