"""Re-measure the notebook chain common-mode offset at full power.

THEORY.md §4f: the prior measurement (8 seeds x 120k walks, XLA, CPU)
read common-mode -9.6 +- 4.8 — only 2 sigma. Before more mechanism
work, re-measure the offset ITSELF at ~100x power on the GPU.

Oracle: Richardson-extrapolated FDM electrode potentials from the
401^2/801^2 grids (u_ext = (4 u_801 - u_401)/3; mutual FDM/FEM
disagreement and the Richardson ratios in tests/test_dcr_survey.py and
THEORY.md §4f bound the oracle error ~0.05).

usage: python tools/nb_offset.py SEEDS WALKS MODE [SEED0]
  MODE in {chain, off, refl, auto}
  NB_CPU=1 to force CPU (debug only).

The script inserts the repo root into sys.path itself.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("NB_CPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"


def main():
    import jax
    if os.environ.get("NB_CPU"):
        jax.config.update("jax_platforms", "cpu")

    from dcrmontecarlo_tpu.models import notebook_survey
    from dcrmontecarlo_tpu.solver import SolverOptions
    from dcrmontecarlo_tpu.survey.dcr import survey_default_options

    S = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    W = int(sys.argv[2]) if len(sys.argv) > 2 else 120_000
    mode = sys.argv[3] if len(sys.argv) > 3 else "chain"
    SEED0 = int(sys.argv[4]) if len(sys.argv) > 4 else 0

    survey, electrodes = notebook_survey()
    survey.source_mis = True

    el = np.asarray(electrodes, np.float32)
    # pinned Richardson(401,801) oracle (tools/gen_oracle_pins.py)
    from dcrmontecarlo_tpu.validation import notebook_oracle_pins

    pins = notebook_oracle_pins()
    np.testing.assert_allclose(pins["electrodes"], el, atol=1e-5)
    ref = pins["richardson"]
    print(f"oracle: pinned richardson(401,801) max|u8-u4|="
          f"{np.abs(pins['fdm_801'] - pins['fdm_401']).max():.3f}",
          flush=True)

    rc = {"chain": "chain", "off": False, "refl": "reflectance",
          "auto": "auto"}[mode]  # ("residual" removed round 4)
    # split_threshold tames the rare huge-|weight| tail walks that
    # otherwise dominate the MEAN common mode (a single +600 electrode
    # deviation was observed at 60k walks without it); splitting is
    # exactly unbiased so it only helps the offset measurement.
    split = float(os.environ.get("NB_SPLIT", "4.0"))
    opts = survey_default_options(
        robin_correction=rc,
        robin_arrival_clamp=float(os.environ.get("NB_CLAMP", "0.02")),
        split_threshold=None if split <= 0 else split,
        backend=os.environ.get("NB_BACKEND", "auto"),
        target_slots=1 << 20 if not os.environ.get("NB_CPU") else 1 << 14,
    )
    solver = survey.make_solver(options=opts)

    biases = np.zeros((S, el.shape[0]))
    errs = np.zeros((S, el.shape[0]))
    for k in range(S):
        t0 = time.perf_counter()
        res = survey.run(electrodes, n_walks=W, max_steps=6000, eps=1.0,
                         seed=SEED0 + k, solver=solver)
        biases[k] = res.potentials - ref
        errs[k] = res.potentials_stderr
        cm = biases[k].mean()
        print(f"seed {SEED0+k}: cm {cm:+.3f} med {np.median(biases[k]):+.3f} "
              f"max|b| {np.abs(biases[k]).max():.2f} "
              f"med-stderr {np.median(errs[k]):.3f} "
              f"t={time.perf_counter()-t0:.0f}s", flush=True)

    cms = biases.mean(axis=1)
    print(f"\nmode={mode} S={S} W={W} seed0={SEED0}")
    print(f"common-mode {cms.mean():+.3f} +- {cms.std(ddof=1)/np.sqrt(S):.3f}"
          f" (per-seed {np.array2string(cms, precision=2)})")
    med = np.median(biases, axis=0)
    print(f"per-electrode median bias: min {med.min():+.2f} "
          f"max {med.max():+.2f}")
    print("electrode bias (mean over seeds):")
    mean_b = biases.mean(axis=0)
    sem_b = biases.std(axis=0, ddof=1) / np.sqrt(S)
    for i in range(el.shape[0]):
        print(f"  x={el[i,0]:+7.1f}  {mean_b[i]:+8.3f} +- {sem_b[i]:.3f}")


main()
