"""THE pinned accuracy-calibration table (round-4 verdict item 3).

One config family, one oracle, one seed set, one metric — so no two docs
can disagree about what each variance tool buys. Base = the SHIPPED
flagship gate config (tests/test_dcr_survey.py::
test_notebook_survey_matches_fdm_oracle): notebook survey,
source_mis=True, survey_default_options() (CRN on, roulette 0.05,
rejection_rounds=2, compaction off), local_majorant="auto",
robin_correction auto->chain. Each arm toggles exactly ONE knob off.

Metric: adjacent dipole voltages — the notebook's plotted observable
(reference testNotebook.ipynb cell 21) — vs the PINNED Richardson(401,801)
FDM oracle (tools/gen_oracle_pins.py), |dV - dV_ref| over (seeds x 20
channels): median, p90, and the walk-count-invariant figure med^2 * t.

Results are pinned in THEORY.md §5 ("Accuracy calibration table") and
cited by survey/dcr.py::survey_default_options and COMPONENT_MAP.md.

usage: python tools/calibration_table.py [SEEDS] [WALKS]   (on the GPU)
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    from dcrmontecarlo_tpu.models import notebook_survey
    from dcrmontecarlo_tpu.survey import survey_default_options
    from dcrmontecarlo_tpu.validation import notebook_oracle_pins

    S = int(sys.argv[1]) if len(sys.argv) > 1 else 24
    W = int(sys.argv[2]) if len(sys.argv) > 2 else 4096

    dv_ref = np.asarray(notebook_oracle_pins()["dv_richardson"]).ravel()

    def measure(label, mis=True, majorant="auto", **opt_overrides):
        survey, electrodes = notebook_survey()
        survey.source_mis = mis
        survey.local_majorant = majorant
        solver = survey.make_solver(
            options=survey_default_options(target_slots=1 << 17,
                                           **opt_overrides))
        run = lambda seed: survey.run(  # noqa: E731
            electrodes, n_walks=W, max_steps=6000, eps=1.0, seed=seed,
            solver=solver)
        run(999)  # compile warmup outside the timer
        errs = []
        t0 = time.perf_counter()
        for seed in range(S):
            result = run(seed)
            errs.append(np.abs(np.asarray(result.voltages).ravel() - dv_ref))
        dt = (time.perf_counter() - t0) / S
        errs = np.stack(errs)
        med = float(np.median(errs))
        p90 = float(np.percentile(errs, 90))
        print(f"{label:10}: med|dVerr|={med:7.3f} p90={p90:8.3f} "
              f"t={dt:5.2f}s  med^2*t={med * med * dt:8.3f}", flush=True)

    print(f"seeds={S} walks={W} oracle=pinned richardson(401,801) "
          f"base=flagship gate config", flush=True)
    if "r5arms" in sys.argv:
        # round-5 add-on arms: does the bench sweep's rounds=1 win
        # (tools/throughput_tradeoff.py) carry over to the notebook
        # accuracy workload, and what does the gate's split=4 config
        # cost/buy on the dV observable?
        measure("base")
        measure("+rounds1", rejection_rounds=1)
        measure("+split4", split_threshold=4.0)
        return
    measure("base")
    measure("-CRN", common_random_numbers=False)
    measure("-roulette", roulette_threshold=None)
    measure("-majorant", majorant=None)
    measure("-chain", robin_correction=False)
    measure("-mis", mis=False)


if __name__ == "__main__":
    main()
