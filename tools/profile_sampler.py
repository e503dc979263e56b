"""Profile the screened-radius sampler's share of the headline bench.

Sweeps rejection_rounds and, with --stub, monkeypatches the sampler with a
closed-form stand-in (BIASED — profiling only) to bound what any cheaper
exact sampler (e.g. a table+IS draw) could recover.

Run on the GPU (one process per card):
    python tools/profile_sampler.py --rounds 1 2 4
    python tools/profile_sampler.py --stub
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def run_once(rejection_rounds: int, stub: bool) -> float:
    import jax
    import jax.numpy as jnp

    from dcrmontecarlo_tpu.models import geophysical_scenario
    from dcrmontecarlo_tpu.solver import SolverOptions, WoStSolver

    if stub:
        import dcrmontecarlo_tpu.sampling.radial as radial

        def _stub(draw, R, sigma_bar, max_rounds, with_weight=False):
            u = draw(jnp.int32(0))
            r = R * jnp.sqrt(jnp.maximum(u[0], 1e-7)
                             * jnp.maximum(u[1], 1e-7))
            if with_weight:
                return r, jnp.ones_like(r)
            return r

        radial._exact_rejection = _stub

    target_slots, n_walks, max_steps, min_quota = 1 << 21, 1 << 19, 500, 32
    survey, electrodes = geophysical_scenario(sharpness=0.5)
    problem = survey.build_problem()
    electrodes = np.asarray(electrodes, np.float32).copy()
    electrodes[:, 1] = -0.5

    solver = WoStSolver(
        problem,
        SolverOptions(target_slots=target_slots, min_quota=min_quota,
                      rejection_rounds=rejection_rounds),
    )
    fn = solver._build_solve_fn(
        n_points=electrodes.shape[0], n_walks=n_walks,
        max_steps=max_steps, eps=0.9,
    )
    pts = np.asarray(electrodes)
    out = fn(pts, jax.random.PRNGKey(0))
    jax.block_until_ready(out)

    steps_total = 0.0
    t0 = time.perf_counter()
    for rep in range(3):
        out = fn(pts, jax.random.PRNGKey(rep + 1))
        jax.block_until_ready(out.total_steps)
        steps_total += float(out.total_steps)
    dt = time.perf_counter() - t0
    rate = steps_total / dt
    print(f"rounds={rejection_rounds} stub={stub}: {rate / 1e9:.3f} G "
          f"steps/s  (steps={steps_total:.3g}, t={dt:.2f}s, "
          f"mean[0]={float(np.asarray(out.mean).ravel()[0]):.5f})",
        flush=True)
    return rate


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, nargs="*", default=[2])
    ap.add_argument("--stub", action="store_true")
    args = ap.parse_args()
    for r in args.rounds:
        run_once(r, args.stub)


if __name__ == "__main__":
    main()
