"""Regenerate the reference's variable-coefficient figure with this
framework.

Reference producer: ``tests/testWostVariableCoefficients.py:181,370``
(committed as ``variable_coefficient_results.png``): Gaussian-bump
diffusion + sinusoidal absorption on a square with a circular Neumann
obstacle; solution heatmap + per-point MC error.

Usage: python examples/variable_coefficient_figure.py [--walks N]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--walks", type=int, default=800)
    ap.add_argument("--grid", type=int, default=21)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "variable_coefficient_results.png"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")

    from dcrmontecarlo_tpu.models import (
        variable_coefficient_problem,
        varcoeff_solve_points,
    )
    from dcrmontecarlo_tpu.solver import SolverOptions, WoStSolver
    from dcrmontecarlo_tpu.utils.plotting import _mpl

    prob = variable_coefficient_problem()
    pts = varcoeff_solve_points(n=args.grid)
    solver = WoStSolver(prob, SolverOptions(target_slots=65536,
                                            max_attenuation=50.0))
    res = solver.solve(pts, n_walks=args.walks, max_steps=600, eps=1e-3,
                       seed=0)

    plt = _mpl()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(13, 5.5))
    for ax, vals, title in (
        (ax1, res.mean, "WoSt solution $u$"),
        (ax2, res.stderr, "MC standard error"),
    ):
        sc = ax.scatter(pts[:, 0], pts[:, 1], c=vals, s=60, cmap="viridis")
        fig.colorbar(sc, ax=ax)
        bpts = np.asarray(prob.dirichlet.points)
        ax.plot(bpts[:, 0], bpts[:, 1], "k-", lw=1.2)
        npts = np.asarray(prob.neumann.points)
        ax.plot(npts[:, 0], npts[:, 1], "r-", lw=1.2)
        ax.set_title(title)
        ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(args.out, dpi=120)
    print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
