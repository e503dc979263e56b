"""DCR-survey walker throughput benchmark.

Prints ONE JSON line on stdout: ``{"metric", "value", "unit",
"vs_baseline"}``; diagnostics, including the platform, device kind and
device count the run used, go to stderr.

Baseline: the reference's sequential Python triple loop executes one
walker-step per interpreter iteration with two torch.jit geometry scans and
two nested autograd calls (``solvers/WoStSolver.py:206-291``), bounding it
at ~1e4 walker-steps/s on CPU (BASELINE.md). ``vs_baseline`` is the speedup
over that 1e4 steps/s bound.

Presets:

* ``full`` — sustained delta-tracking survey throughput (walker-steps/s);
* ``short`` — launch-bound harmonic walks of ~10 steps;
* ``accuracy`` — time to accuracy on the 1000 m notebook survey against
  the pinned FDM oracle;
* ``smoke`` — a tiny run of the ``full`` pipeline that the CPU can do.

The timed presets (full, short, accuracy) need a GPU and exit non-zero
without one. The case builders (``full_case``, ``short_case``,
``accuracy_case``) are shared with ``chip_smoke.py``.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

BASELINE_STEPS_PER_S = 1e4  # reference structural bound (BASELINE.md)
# the checkout's root (the working directory when run through exec)
ROOT = (os.path.dirname(os.path.abspath(__file__))
        if "__file__" in globals() else os.getcwd())


def configure_compile_cache():
    """Keep JAX's persistent compile cache in ``JAX_COMPILATION_CACHE_DIR``
    when it is set (JAX reads it itself), else in ``.jax_cache/`` beside
    this file."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(ROOT, ".jax_cache"))


def device_line():
    """``platform device_kind xcount`` of the devices JAX will use."""
    import jax

    d = jax.devices()
    return f"{d[0].platform} {d[0].device_kind} x{len(d)}"


def full_case(backend="auto", target_slots=1 << 21, n_walks=1 << 19,
              max_steps=500, min_quota=32, **opts):
    """Sustained delta-tracking survey: the 9-electrode geophysical
    scenario, electrodes just inside the half-space.

    ``rejection_rounds=1`` caps the screened-radius redraws at one round
    (exactly unbiased: capped lanes carry the closed-form importance
    weight, sampling/radial.py). The case runs without the survey
    variance controls (roulette, splitting): they change which steps run,
    and steps/s is only comparable on the bare configuration.

    Returns ``(solver, points, n_walks, max_steps, eps)``.
    """
    from dcrmontecarlo_tpu.models import geophysical_scenario
    from dcrmontecarlo_tpu.solver import SolverOptions, WoStSolver

    survey, electrodes = geophysical_scenario(sharpness=0.5)
    problem = survey.build_problem()
    pts = np.asarray(electrodes, np.float32).copy()
    pts[:, 1] = -0.5  # start just inside the half-space
    solver = WoStSolver(problem, SolverOptions(
        target_slots=target_slots, min_quota=min_quota, rejection_rounds=1,
        backend=backend, **opts))
    return solver, pts, n_walks, max_steps, 0.9


def short_case(backend="auto", target_slots=1 << 19, n_walks=1 << 21,
               max_steps=200, **opts):
    """Launch-bound regime: harmonic walks on the unit square last ~10
    steps, so per-solve overheads weigh against little work per walk.
    Per-lane quotas of 32 walks amortize the walk-length straggler tail.

    Returns ``(solver, points, n_walks, max_steps, eps)``.
    """
    from dcrmontecarlo_tpu import Problem, WoStSolver, square_loop
    from dcrmontecarlo_tpu.solver import SolverOptions

    prob = Problem(dirichlet=square_loop(1.0),
                   bc_dirichlet=lambda x, y: x + 2.0 * y)
    solver = WoStSolver(prob, SolverOptions(
        target_slots=target_slots, min_quota=32, backend=backend, **opts))
    pts = np.array([[0.0, 0.0], [0.5, 0.3], [-0.4, 0.6]], np.float32)
    return solver, pts, n_walks, max_steps, 1e-3


def accuracy_case(backend="auto", target_slots=1 << 17, n_walks=4096,
                  max_steps=6000, **opts):
    """Time to accuracy on the 1000 m notebook survey: the survey defaults
    plus ``local_majorant='auto'`` and the auto-enabled Robin chord chain.
    The dipole voltages are compared with the pinned 401^2 FDM oracle
    (``notebook_oracle_pins()['dv_401']``).

    Returns ``(solver, points, n_walks, max_steps, eps)``.
    """
    from dcrmontecarlo_tpu.models import notebook_survey
    from dcrmontecarlo_tpu.solver import WoStSolver
    from dcrmontecarlo_tpu.survey.dcr import survey_default_options

    survey, electrodes = notebook_survey()
    survey.local_majorant = "auto"
    solver = WoStSolver(survey.build_problem(), survey_default_options(
        target_slots=target_slots, backend=backend, **opts))
    pts = np.asarray(electrodes, np.float32).copy()
    pts[:, 1] = survey.surface_y - survey.electrode_nudge
    return solver, pts, n_walks, max_steps, 1.0


def _require_gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"timed presets need a GPU; JAX sees {device_line()}",
              file=sys.stderr)
        sys.exit(1)


def accuracy_preset(n_rep=8):
    """Median |dV error| against the FDM oracle x wall-clock per solve.

    Reports the walk-count-invariant med|dV err| * sqrt(t) and, as
    vs_baseline, the time ratio for the reference solver to run the SAME
    ensemble at its ~1e4 steps/s structural bound."""
    from dcrmontecarlo_tpu.validation import notebook_oracle_pins

    solver, pts, n_walks, max_steps, eps = accuracy_case()
    dv_ref = notebook_oracle_pins()["dv_401"]
    solver.solve(pts, n_walks=n_walks, max_steps=max_steps, eps=eps,
                 seed=999)
    errs = []
    steps_total = 0.0
    t0 = time.perf_counter()
    for seed in range(n_rep):
        res = solver.solve(pts, n_walks=n_walks, max_steps=max_steps,
                           eps=eps, seed=seed)
        dv = np.asarray(res.mean[:-1] - res.mean[1:]).ravel()
        errs.append(np.abs(dv - dv_ref))
        steps_total += float(res.total_steps)
    dt = (time.perf_counter() - t0) / n_rep
    med_err = float(np.median(np.stack(errs)))
    ref_time = (steps_total / n_rep) / BASELINE_STEPS_PER_S
    ratio = ref_time / dt
    print(f"flagship config: med|dV err|={med_err:.3g} t={dt:.4f}s "
          f"err*sqrt(t)={med_err * np.sqrt(dt):.3g} "
          f"steps/solve={steps_total / n_rep:.3g} "
          f"(reference at 1e4 steps/s: {ref_time:.0f}s) "
          f"device={device_line()}",
          file=sys.stderr)
    print(json.dumps({
        "metric": "dcr_notebook_time_to_accuracy_speedup",
        "value": ratio,
        "unit": "x (reference structural bound / measured, "
                "same ensemble, FDM-oracle-checked)",
        "vs_baseline": ratio,
    }))


def short_walk_preset(repeats: int):
    """Enqueue every repeat and block once: the production pattern for
    streams of short solves, where per-call dispatch is not hidden behind
    compute."""
    import jax

    solver, pts, n_walks, max_steps, eps = short_case()
    repeats = max(repeats, 10)  # pipelining needs a queue to amortize
    fn = solver._build_solve_fn(len(pts), n_walks, max_steps, eps)
    pts_j = jax.numpy.asarray(pts)
    jax.block_until_ready(fn(pts_j, jax.random.PRNGKey(0)))
    t0 = time.perf_counter()
    outs = [fn(pts_j, jax.random.PRNGKey(rep + 1))
            for rep in range(repeats)]
    steps_total = sum(float(jax.device_get(o.total_steps)) for o in outs)
    dt = time.perf_counter() - t0
    rate = steps_total / dt
    print(json.dumps({
        "metric": "short_walk_harmonic_steps_per_sec_per_chip",
        "value": rate,
        "unit": "walker-steps/s",
        "vs_baseline": rate / BASELINE_STEPS_PER_S,
    }))
    print(f"short preset: steps={steps_total:.3g} time={dt:.4f}s "
          f"mean_len={steps_total / (repeats * len(pts) * n_walks):.1f} "
          f"device={device_line()}",
          file=sys.stderr)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["smoke", "full", "accuracy",
                                         "short"],
                    default="full")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()

    configure_compile_cache()
    if args.preset != "smoke":
        _require_gpu()
    if args.preset == "accuracy":
        accuracy_preset()
        return
    if args.preset == "short":
        short_walk_preset(args.repeats)
        return

    import jax

    if args.preset == "smoke":
        solver, pts, n_walks, max_steps, eps = full_case(
            target_slots=4096, n_walks=64, max_steps=200, min_quota=4)
    else:
        solver, pts, n_walks, max_steps, eps = full_case()

    fn = solver._build_solve_fn(
        n_points=pts.shape[0], n_walks=n_walks, max_steps=max_steps, eps=eps)
    out = fn(pts, jax.random.PRNGKey(0))  # compile
    jax.block_until_ready(out)

    steps_total = 0.0
    t0 = time.perf_counter()
    for rep in range(args.repeats):
        out = fn(pts, jax.random.PRNGKey(rep + 1))
        jax.block_until_ready(out.total_steps)
        steps_total += float(out.total_steps)
    dt = time.perf_counter() - t0

    rate = steps_total / dt
    print(json.dumps({
        "metric": "dcr_survey_walker_steps_per_sec_per_chip",
        "value": rate,
        "unit": "walker-steps/s",
        "vs_baseline": rate / BASELINE_STEPS_PER_S,
    }))
    print(
        f"preset={args.preset} walks={n_walks}x{len(pts)}pts "
        f"steps={steps_total:.3g} time={dt:.4f}s "
        f"mean[0]={float(np.asarray(out.mean).ravel()[0]):.5f} "
        f"device={device_line()}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
