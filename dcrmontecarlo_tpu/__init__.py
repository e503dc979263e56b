"""dcrmontecarlo_tpu — Walk-on-Stars Monte Carlo PDE solver in JAX.

A brand-new JAX/Pallas framework with the capabilities of
Tsuchijo/DCRMonteCarlo: grid-free Monte Carlo solution of the elliptic PDE
``-div(alpha grad u) + sigma u = f`` on 2D domains with mixed
Dirichlet/Neumann polyline boundaries (Walk-on-Spheres / Walk-on-Stars with
delta tracking), applied to DC-resistivity survey forward modelling.

Unlike the reference's sequential per-walker Python loop
(``solvers/WoStSolver.py:182-291``), the core here is a batched SoA
``lax.while_loop`` over millions of walkers with a counter-based RNG,
vectorized geometry queries, a fused Pallas walk kernel for NVIDIA GPUs,
and shard_map data parallelism over a device mesh.
"""

from .geometry import Polyline, square_loop, circle_loop, func_to_polyline
from .problems import Problem
from .solver import WoStSolver, SolveResult, SolverOptions

__all__ = [
    "Polyline",
    "square_loop",
    "circle_loop",
    "func_to_polyline",
    "Problem",
    "WoStSolver",
    "SolveResult",
    "SolverOptions",
]
__version__ = "0.1.0"
