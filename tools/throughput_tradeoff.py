"""stderr^2 x time sweep on the headline bench workload (verdict-r4 #8).

The headline preset's rejection_rounds=2 was chosen in round 3 as the
stderr^2*t optimum over the rounds axis ALONE (rounds=1 is ~19% faster
per step but its capped-lane importance weights cost more variance than
the time saved). Round 5 asks whether rounds=1 becomes the optimum once
the round-5 variance controls run with it — roulette 0.05 is now the
production default, and split_threshold clips the weight tail (at the
cost of forcing the multi-launch path: splitting needs launch
boundaries, so it disables the adaptive single-launch mode).

Metric: med_p(stderr_p^2) * t_solve on the bench workload (2^19 walks,
500 steps), 3 timed solves per arm after compile, fresh seeds. Lower is
better; the stderr landscape is smooth here (no CRN, single source), so
the median over the 25 points is stable.

usage: python tools/throughput_tradeoff.py
"""
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ARMS = [
    ("r2", dict(rejection_rounds=2)),          # headline control
    ("r1", dict(rejection_rounds=1)),          # faster/step, weighted caps
    ("r1-split4", dict(rejection_rounds=1, split_threshold=4.0)),
]


def main():
    import jax

    from dcrmontecarlo_tpu.models import geophysical_scenario
    from dcrmontecarlo_tpu.solver import SolverOptions, WoStSolver

    survey, electrodes = geophysical_scenario(sharpness=0.5)
    problem = survey.build_problem()
    pts = np.asarray(electrodes, np.float32).copy()
    pts[:, 1] = -0.5

    n_walks, max_steps = 1 << 19, 500
    out_rows = {}
    for label, kw in ARMS:
        solver = WoStSolver(problem, SolverOptions(
            target_slots=1 << 21, min_quota=32, **kw))
        t0 = time.perf_counter()
        print(f"{label}: warmup compile...", flush=True)
        solver.solve(pts, n_walks=min(n_walks, 64), max_steps=max_steps,
                     eps=0.9, seed=0)
        print(f"{label}: warmup done {time.perf_counter() - t0:.0f}s; "
              "full compile...", flush=True)
        t0 = time.perf_counter()
        fn = solver._build_solve_fn(len(pts), n_walks, max_steps, 0.9)
        out = fn(jax.numpy.asarray(pts), jax.random.PRNGKey(0))
        jax.block_until_ready(out)
        print(f"{label}: full compile done {time.perf_counter() - t0:.0f}s",
              flush=True)
        times, meds, steps = [], [], 0.0
        for rep in range(3):
            t0 = time.perf_counter()
            out = fn(jax.numpy.asarray(pts), jax.random.PRNGKey(rep + 1))
            jax.block_until_ready(out.total_steps)
            times.append(time.perf_counter() - t0)
            meds.append(float(np.median(np.asarray(out.stderr) ** 2)))
            steps += float(out.total_steps)
        t = float(np.median(times))
        v = float(np.median(meds))
        out_rows[label] = dict(t=t, med_stderr2=v, fom=v * t,
                               steps_per_s=steps / sum(times))
        print(f"{label:16s} t={t:.3f}s med(stderr^2)={v:.4g} "
              f"stderr2*t={v * t:.4g} rate={steps / sum(times):.3g}",
              flush=True)
    best = min(out_rows, key=lambda k: out_rows[k]["fom"])
    print(f"best: {best}")
    print(json.dumps(out_rows))


if __name__ == "__main__":
    main()
