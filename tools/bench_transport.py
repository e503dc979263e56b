"""Headline-bench A/B: screened_sampler transport vs exact (GPU)."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np


def run(sampler, rounds=2):
    import jax

    from dcrmontecarlo_tpu.models import geophysical_scenario
    from dcrmontecarlo_tpu.solver import SolverOptions, WoStSolver

    survey, electrodes = geophysical_scenario(sharpness=0.5)
    problem = survey.build_problem()
    electrodes = np.asarray(electrodes, np.float32).copy()
    electrodes[:, 1] = -0.5
    solver = WoStSolver(problem, SolverOptions(
        target_slots=1 << 21, min_quota=32,
        rejection_rounds=rounds, screened_sampler=sampler))
    fn = solver._build_solve_fn(n_points=electrodes.shape[0],
                                n_walks=1 << 19, max_steps=500, eps=0.9)
    pts = np.asarray(electrodes)
    out = fn(pts, jax.random.PRNGKey(0))
    jax.block_until_ready(out)
    steps = 0.0
    t0 = time.perf_counter()
    for rep in range(3):
        out = fn(pts, jax.random.PRNGKey(rep + 1))
        jax.block_until_ready(out.total_steps)
        steps += float(out.total_steps)
    dt = time.perf_counter() - t0
    print(f"{sampler}(rounds={rounds}): {steps / dt / 1e9:.3f} G steps/s "
          f"(t={dt:.2f}s, steps={steps:.3g}, "
          f"mean[0]={float(np.asarray(out.mean).ravel()[0]):.5f}, "
          f"stderr[0]={float(np.asarray(out[1]).ravel()[0]):.2e})",
          flush=True)


if __name__ == "__main__":
    for arg in sys.argv[1:] or ["transport", "exact"]:
        run(arg)
