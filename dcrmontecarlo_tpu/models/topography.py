"""Topographic DCR survey (heightmap surfaces via ``func_to_polyline``).

The reference ships the heightmap->polyline builder
(``geometry/PolylinesSimple.py:226-240``) and the SimPEG notebook defines
surface topography (``x_topo``/``z_topo`` interpolation, cell 3) but never
runs the MC solver over non-flat terrain. This model closes that gap: a
Neumann surface following ``height(x)`` with many segments (exercising the
segment-table kernel path), Dirichlet far-field sides/bottom, electrodes
draped on the terrain and nudged inward along the local downhill normal.
"""

from typing import Callable, Tuple

import numpy as np

from ..geometry.polyline import Polyline, func_to_polyline
from ..problems.fields import gaussian_dipole
from .dcr_scenarios import _anomalous_conductivity
from ..problems.problem import Problem

__all__ = ["topographic_survey_problem", "drape_electrodes", "rolling_hills"]


def rolling_hills(amplitude: float = 8.0, wavelength: float = 80.0):
    """Gentle sinusoidal terrain ``h(x) = A sin(2 pi x / L)``."""

    def h(x):
        return amplitude * np.sin(2.0 * np.pi * x / wavelength)

    return h


def drape_electrodes(height_fn: Callable, xs, nudge: float = 0.25) -> np.ndarray:
    """Electrode positions on the terrain, nudged inward along the local
    (downhill) surface normal so walks start strictly inside the domain."""
    xs = np.asarray(xs, np.float64)
    h = np.asarray(height_fn(xs), np.float64)
    dx = 1e-3
    slope = (np.asarray(height_fn(xs + dx)) - np.asarray(height_fn(xs - dx))) / (2 * dx)
    # inward normal of y = h(x): (slope, -1)/sqrt(1+slope^2)
    norm = np.sqrt(1.0 + slope * slope)
    ex = xs + nudge * slope / norm
    ey = h - nudge / norm
    return np.stack([ex, ey], axis=1).astype(np.float32)


def topographic_survey_problem(
    height_fn: Callable = None,
    half_width: float = 200.0,
    depth: float = 300.0,
    resolution: float = 2.0,
    background: float = 1e2,
    anomalies=(((-40.0, -50.0), 15.0, 1e1), ((50.0, -60.0), 15.0, 1e3)),
    sharpness: float = 0.5,
    current_a=(-20.0, None),
    current_b=(20.0, None),
    current: float = 1.0,
    source_width: float = 0.5,
    source_depth: float = 1.5,
) -> Tuple[Problem, Callable]:
    """DCR forward problem under topography.

    ``current_a/b`` x-positions sit on the terrain (y resolved from the
    heightmap, buried ``source_depth`` below it). Returns ``(Problem,
    height_fn)``.
    """
    if height_fn is None:
        height_fn = rolling_hills()

    # Neumann surface: heightmap polyline across the full width
    # func_to_polyline now includes x_max exactly (the historical
    # + resolution compensated a float-arange shortfall and would
    # overshoot the domain today)
    neumann = func_to_polyline(height_fn, -half_width, half_width,
                               resolution)
    pts = np.asarray(neumann.points)
    y_left = float(pts[0, 1])
    y_right = float(pts[-1, 1])
    dirichlet = Polyline.from_points([
        [pts[0, 0], y_left],
        [-half_width, -depth],
        [half_width, -depth],
        [pts[-1, 0], y_right],
    ])

    conductivity = _anomalous_conductivity(
        background=background, anomalies=anomalies, sharpness=sharpness
    )

    ax = float(current_a[0])
    bx = float(current_b[0])
    a_pos = (ax, float(height_fn(np.asarray(ax))) - source_depth)
    b_pos = (bx, float(height_fn(np.asarray(bx))) - source_depth)

    problem = Problem(
        dirichlet=dirichlet,
        neumann=neumann,
        bc_dirichlet=lambda x, y: 0.0 * x,
        source=gaussian_dipole(a_pos, b_pos, current, source_width),
        alpha=conductivity,
    )
    return problem, height_fn
