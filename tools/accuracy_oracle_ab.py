"""Oracle-grounded time-to-accuracy A/B on the notebook survey (GPU).

Per config: 16 seeds at 4096 walks; report median-over-(seeds,channels)
|dV - dV_fdm| and wall-clock, and err*sqrt(t) (walk-count-invariant).
"""
import os, sys, time
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np


def main():
    import jax
    from dcrmontecarlo_tpu.models import notebook_survey
    from dcrmontecarlo_tpu.solver import SolverOptions, WoStSolver
    from dcrmontecarlo_tpu.survey.dcr import survey_default_options
    from dcrmontecarlo_tpu.validation import fdm_solve

    survey0, electrodes = notebook_survey()
    prob0 = survey0.build_problem()
    alpha_v = jax.vmap(lambda x, y: prob0.alpha(x, y))
    src_v = jax.vmap(lambda x, y: prob0.source(x, y))
    alpha_np = lambda X, Y: np.asarray(alpha_v(
        X.ravel().astype(np.float32), Y.ravel().astype(np.float32))
    ).reshape(X.shape)
    source_np = lambda X, Y: np.asarray(src_v(
        X.ravel().astype(np.float32), Y.ravel().astype(np.float32))
    ).reshape(X.shape)
    fdm = fdm_solve(bounds=((-500.0, 500.0), (-1000.0, 1.0)),
                    alpha=alpha_np, source=source_np,
                    neumann_top=True, nx=401, ny=401)
    ref = fdm(np.asarray(electrodes, np.float32))
    dv_ref = ref[:-1] - ref[1:]

    def measure(label, mis, opts, majorant=None):
        survey, electrodes = notebook_survey()
        survey.source_mis = mis
        if majorant is not None:
            survey.local_majorant = majorant
        problem = survey.build_problem()
        solver = WoStSolver(problem, opts)
        pts = np.asarray(electrodes, np.float32).copy()
        pts[:, 1] = survey.surface_y - survey.electrode_nudge
        solver.solve(pts, n_walks=4096, max_steps=6000, eps=1.0, seed=999)
        errs = []
        t0 = time.perf_counter()
        for seed in range(16):
            res = solver.solve(pts, n_walks=4096, max_steps=6000, eps=1.0,
                               seed=seed)
            dv = np.asarray(res.mean[:-1] - res.mean[1:]).ravel()
            errs.append(np.abs(dv - dv_ref))
        dt = (time.perf_counter() - t0) / 16
        errs = np.stack(errs)
        med = float(np.median(errs))
        p90 = float(np.percentile(errs, 90))
        print(f"{label:22}: med|dVerr|={med:7.2f} p90={p90:8.2f} "
              f"t={dt:.2f}s  err*sqrt(t)={med*np.sqrt(dt):7.2f}", flush=True)

    base = dict(target_slots=1 << 17)
    measure("bare", False, SolverOptions(**base))
    measure("defaults", False, survey_default_options(**base))
    measure("defaults+mis", True, survey_default_options(**base))
    measure("tuned(maj)", False, survey_default_options(**base),
            majorant="auto")
    measure("tuned(maj)+mis", True, survey_default_options(**base),
            majorant="auto")


if __name__ == "__main__":
    main()
