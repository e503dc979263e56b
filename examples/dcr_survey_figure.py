"""Regenerate the reference's DCR scenario figure with this framework.

Reference producer: ``tests/testGeophysicalScenario.py:156-223`` (committed
as ``dcr_survey_results.png``): 200 m survey, 1 A Gaussian dipole at
+/-10 m, conductors 10 / 1000 S/m in a 100 S/m background, 9 surface
electrodes — here solved with the batched WoSt solver and drawn with
``plot_voltage_profile``.

Usage: python examples/dcr_survey_figure.py [--walks N] [--out PATH]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--walks", type=int, default=4000)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "dcr_survey_results.png"))
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")

    from dcrmontecarlo_tpu.models import geophysical_scenario
    from dcrmontecarlo_tpu.solver import SolverOptions
    from dcrmontecarlo_tpu.utils.plotting import plot_voltage_profile

    survey, electrodes = geophysical_scenario(sharpness=0.5)
    survey.source_mis = True
    result = survey.run(
        electrodes, n_walks=args.walks, max_steps=800, eps=0.5, seed=0,
        options=SolverOptions(target_slots=65536,
                              common_random_numbers=True),
    )
    plot_voltage_profile(result, survey=survey, save_path=args.out)
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
