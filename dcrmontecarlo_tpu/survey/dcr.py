"""DC-resistivity survey layer (JAX rebuild of C17/C18).

Builds electrode geometries, dipole current sources, and converts solved
potentials into dipole voltage differences and apparent resistivities — the
capabilities exercised by the reference's DCR scenario script
(``tests/testGeophysicalScenario.py``) and SimPEG cross-validation notebook
(``tests/testNotebook.ipynb`` cells 3, 17-21, which imports SimPEG's
``apparent_resistivity_from_voltage``).

Geometric factors: the PDE solved here is strictly 2D (line sources), so
the native apparent-resistivity conversion uses the 2D half-plane factor

    ``rho_a = pi * dV / (I * ln[(r_BM r_AN)/(r_AM r_BN)])``

derived from the half-plane line-source potential
``u(r) = -(I rho / pi) ln r``. The conventional 3D point-source half-space
factor ``rho_a = 2 pi dV / (I [1/AM - 1/BM - 1/AN + 1/BN])`` (what SimPEG's
``apparent_resistivity_from_voltage`` applies to field data) is also
provided for users comparing against 3D conventions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np

from ..geometry.polyline import Polyline
from ..problems.fields import GaussianMixture, gaussian_dipole
from ..problems.problem import Problem
from ..solver.wost import SolveResult, SolverOptions, WoStSolver

__all__ = [
    "surface_electrode_line",
    "dipole_voltages",
    "apparent_resistivity_2d",
    "apparent_resistivity_halfspace",
    "DCRSurvey",
    "SurveyResult",
    "Pseudosection",
    "halfspace_domain",
    "dipole_dipole_pairs",
    "run_pseudosection",
    "survey_default_options",
]


def survey_default_options(**overrides) -> SolverOptions:
    """The survey pipelines' default :class:`SolverOptions`.

    The knobs were chosen by the pinned accuracy-calibration table
    (THEORY.md §5, ``tools/calibration_table.py``: one config, one pinned
    Richardson oracle, 24 seeds, one-knob-off arms):

    * ``common_random_numbers=True`` — dipole voltages are differences;
      slot-matched streams correlate the shared MC noise so it cancels in
      them. Free (a stream relabeling); the single biggest accuracy lever
      in the table. Also tightly correlates CLOSE receivers (verified
      bit-identical at zero spacing).
    * ``compaction=False`` — the adaptive single kernel launch already
      ends each block when its quota drains.
    * ``roulette_threshold=0.05`` — unbiased low-weight kill.
    * ``rejection_rounds=2`` — the notebook-survey setting of the table
      (64 wastes rounds).

    Their time cost on the GPU is not measured yet (PERF.md). Any keyword
    overrides the default (e.g. ``survey_default_options(
    split_threshold=4.0)`` for the flagship gate's configuration).
    """
    base = dict(
        common_random_numbers=True,
        compaction=False,
        roulette_threshold=0.05,
        rejection_rounds=2,
    )
    base.update(overrides)
    return SolverOptions(**base)


def surface_electrode_line(x_range, spacing: float, y: float = 0.0) -> np.ndarray:
    """Measurement electrodes along the surface.

    Rebuild of ``create_surface_measurement_grid``
    (``tests/testGeophysicalScenario.py:58-74``).
    """
    # linspace with a floored count (float-tolerant): float arange
    # overshoots the stop by a full spacing on ~half of spacing/extent
    # combinations, and a ROUNDED count still overshoots by up to
    # spacing/2 when the extent is not a multiple of spacing — the last
    # electrode must never exceed x_range[1]
    n = int(np.floor((x_range[1] - x_range[0]) / spacing + 1e-6)) + 1
    x = np.linspace(x_range[0], x_range[0] + (n - 1) * spacing, n,
                    dtype=np.float32)
    return np.stack([x, np.full_like(x, y)], axis=1)


def halfspace_domain(
    half_width: float,
    depth: float,
    surface_y: float = 0.0,
):
    """Dirichlet sides/bottom + Neumann (insulating) top surface.

    The standard DCR domain of both reference scenarios
    (``testGeophysicalScenario.py:88-106``; notebook cell 18): the far-field
    box is grounded (u = 0) and the air interface is a zero-flux Neumann
    segment.

    Returns:
        ``(dirichlet, neumann)`` polylines. The Dirichlet chain is open
        (left side, bottom, right side); the Neumann chain is the top
        segment.
    """
    dirichlet = Polyline.from_points(
        [
            [-half_width, surface_y],
            [-half_width, surface_y - depth],
            [half_width, surface_y - depth],
            [half_width, surface_y],
        ]
    )
    neumann = Polyline.from_points(
        [[-half_width, surface_y], [half_width, surface_y]]
    )
    return dirichlet, neumann


def dipole_voltages(potentials: np.ndarray) -> np.ndarray:
    """Adjacent-electrode dipole receiver voltages ``V_M - V_N``.

    Matches the notebook's receiver layout (cell 3:
    ``locations_m = electrodes[:-1]; locations_n = electrodes[1:]``) and its
    plotted differences (cell 21: ``voltages[:-1] - voltages[1:]``).
    """
    potentials = np.asarray(potentials)
    return potentials[:-1] - potentials[1:]


def _pair_distances(a, b, m, n):
    a, b, m, n = (np.asarray(v, np.float64) for v in (a, b, m, n))
    r = lambda p, q: np.sqrt(((p - q) ** 2).sum(axis=-1))
    return r(a, m), r(b, m), r(a, n), r(b, n)


def apparent_resistivity_2d(dv, current, a, b, m, n):
    """Apparent resistivity for 2D line sources in a half-plane.

    ``rho_a = pi dV / (I ln[(r_BM r_AN)/(r_AM r_BN)])``.

    Args:
        dv: ``(R,)`` dipole voltages ``V_M - V_N``.
        current: injected current I.
        a, b: ``(2,)`` current electrode positions.
        m, n: ``(R, 2)`` potential electrode positions.
    """
    am, bm, an, bn = _pair_distances(a, b, np.asarray(m), np.asarray(n))
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.log((bm * an) / (am * bn))
        rho = np.pi * np.asarray(dv, np.float64) / (current * g)
    # receivers coinciding with a current electrode have no defined factor
    return np.where(np.isfinite(g) & (np.abs(g) > 0), rho, np.nan)


def apparent_resistivity_halfspace(dv, current, a, b, m, n):
    """Apparent resistivity with the conventional 3D point-source factor
    (SimPEG's ``apparent_resistivity_from_voltage`` convention, notebook
    cell 0)."""
    am, bm, an, bn = _pair_distances(a, b, np.asarray(m), np.asarray(n))
    with np.errstate(divide="ignore", invalid="ignore"):
        g = 1.0 / am - 1.0 / bm - 1.0 / an + 1.0 / bn
        rho = 2.0 * np.pi * np.asarray(dv, np.float64) / (current * g)
    return np.where(np.isfinite(g) & (np.abs(g) > 0), rho, np.nan)


class SurveyResult(NamedTuple):
    electrodes: np.ndarray          # (N, 2)
    potentials: np.ndarray          # (N,)
    potentials_stderr: np.ndarray   # (N,)
    voltages: np.ndarray            # (N-1,) adjacent dipole voltages
    voltages_stderr: np.ndarray     # (N-1,) (correlated-walk upper bound)
    apparent_resistivity: np.ndarray  # (N-1,) 2D line-source convention
    solve: SolveResult


@dataclass
class DCRSurvey:
    """A DC-resistivity forward-modelling survey.

    Bundles the half-space domain, a current dipole, and a conductivity
    field into a solvable :class:`Problem` and post-processes potentials
    into dipole voltages / apparent resistivities — the full pipeline of
    the reference's scenario test + notebook.

    Args:
        half_width / depth: domain extents (m).
        current_a / current_b: +/- current electrode positions.
        conductivity: field ``alpha(x, y)`` in S/m.
        current: injected current (A).
        source_width: Gaussian regularization width of the current
            electrodes (reference uses 0.5 m at 200 m scale, 5 m at
            1000 m scale).
    """

    half_width: float
    depth: float
    current_a: tuple
    current_b: tuple
    conductivity: callable
    current: float = 1.0
    source_width: float = 0.5
    surface_y: float = 0.0
    sigma_bar_override: Optional[float] = None
    electrode_nudge: float = 0.1
    source_mis: bool = False  # source-directed MIS NEE (large variance
                              # reduction for narrow sources; supported by
                              # both the XLA and Pallas backends)
    local_majorant: object = None  # None | "auto" | LocalMajorant — two-
                              # level delta-tracking majorant (see
                              # problems/majorant.py): far-field walkers
                              # exclude the high-sigma' anomaly/air regions
                              # from their ball and fly at the background
                              # mean free path. Exactly unbiased.

    def _bury_source(self, pos) -> tuple:
        """Sink a current electrode whose Gaussian overlaps the Neumann
        surface to ~2 widths below it. A regularized source centered on
        (or within ~2 sigma of) the insulating surface loses part of its
        mass — its injected current — outside the domain, biasing apparent
        resistivities low (2x for an exactly-on-surface source); a shallow
        buried source is image-equivalent to a surface source at
        electrode-spacing scales. Sources that were deliberately placed
        below the surface but still overlap it are relocated too — with a
        warning, since that changes the requested geometry."""
        x, y = float(pos[0]), float(pos[1])
        depth = max(self.electrode_nudge, 2.0 * self.source_width)
        if abs(y - self.surface_y) < depth:
            if abs(y - self.surface_y) > self.electrode_nudge:
                import warnings

                warnings.warn(
                    f"current electrode at y={y:g} is within 2 source "
                    f"widths of the surface y={self.surface_y:g}; burying "
                    f"it to y={self.surface_y - depth:g} so the full "
                    "current enters the half-space. Reduce source_width "
                    "to keep a deliberately shallow source in place."
                )
            y = self.surface_y - depth
        return (x, y)

    def make_solver(self, options: SolverOptions = None) -> WoStSolver:
        """Build a reusable solver for this survey.

        ``run()`` constructs a fresh Problem + solver per call, which
        re-traces and re-compiles the walk; loops over seeds or repeated
        surveys should build ONE solver here and pass it to
        ``run(..., solver=...)`` (compiled solves are cached per shape).

        ``options`` defaults to :func:`survey_default_options` (the
        measured optima).
        """
        if options is None:
            options = survey_default_options()
        return WoStSolver(self.build_problem(), options)

    def build_problem(self) -> Problem:
        dirichlet, neumann = halfspace_domain(
            self.half_width, self.depth, self.surface_y
        )
        a = self._bury_source(self.current_a)
        b = self._bury_source(self.current_b)
        importance = None
        if self.source_mis:
            importance = GaussianMixture.from_components([
                (a, self.source_width, 0.5),
                (b, self.source_width, 0.5),
            ])
        return Problem(
            dirichlet=dirichlet,
            neumann=neumann,
            bc_dirichlet=lambda x, y: 0.0 * x,  # far-field ground
            source=gaussian_dipole(a, b, self.current, self.source_width),
            alpha=self.conductivity,
            sigma_bar_override=self.sigma_bar_override,
            source_importance=importance,
            local_majorant=self.local_majorant,
        )

    def run(
        self,
        electrodes: np.ndarray,
        n_walks: int = 1000,
        max_steps: int = 500,
        eps: float = 0.9,
        seed: int = 0,
        options: SolverOptions = None,
        solver: WoStSolver = None,
    ) -> SurveyResult:
        """Solve the survey at ``electrodes``.

        ``options`` defaults to :func:`survey_default_options` — notably
        common random numbers ON: the survey's observables are dipole
        voltage DIFFERENCES, and slot-matched streams cancel most of the
        shared MC noise between adjacent electrodes (works on both the
        XLA and Pallas backends). Pass explicit ``options`` to opt out.
        """
        if solver is None:
            if options is None:
                options = survey_default_options()
            solver = WoStSolver(self.build_problem(), options)
        # Electrodes sitting exactly on the Neumann surface start their
        # first step with a uniform (not hemisphere) direction and can leak
        # out of the half-space; nudge them just inside, as the reference
        # notebook does (cell 19: electrodes at y = -0.1).
        pts = np.asarray(electrodes, np.float32).copy()
        on_surface = np.abs(pts[:, 1] - self.surface_y) < self.electrode_nudge
        pts[on_surface, 1] = self.surface_y - self.electrode_nudge
        res = solver.solve(
            pts, n_walks=n_walks, max_steps=max_steps, eps=eps, seed=seed
        )
        dv = dipole_voltages(res.mean)
        dv_err = np.sqrt(res.stderr[:-1] ** 2 + res.stderr[1:] ** 2)
        rho_a = apparent_resistivity_2d(
            dv,
            self.current,
            np.asarray(self.current_a, np.float64),
            np.asarray(self.current_b, np.float64),
            electrodes[:-1],
            electrodes[1:],
        )
        return SurveyResult(
            electrodes=np.asarray(electrodes),
            potentials=res.mean,
            potentials_stderr=res.stderr,
            voltages=dv,
            voltages_stderr=dv_err,
            apparent_resistivity=rho_a,
            solve=res,
        )


def dipole_dipole_pairs(n_electrodes: int, num_rx_per_src: int = 10):
    """Enumerate dipole-dipole (source, receiver) index pairs.

    SimPEG-convention survey generation (the notebook builds its survey with
    ``generate_dcip_sources_line(survey_type="dipole-dipole", ...,
    num_rx_per_src=10)``, cell 3): source dipole at electrodes ``(i, i+1)``,
    receiver dipoles ``(j, j+1)`` for ``j`` from ``i+2`` up to
    ``i+1+num_rx_per_src``.

    Returns:
        ``(sources, receivers)``: source list of ``(a, b)`` index tuples and
        per-source lists of ``(m, n)`` receiver index tuples.
    """
    sources, receivers = [], []
    for i in range(n_electrodes - 3):
        rx = [
            (j, j + 1)
            for j in range(i + 2, min(i + 2 + num_rx_per_src, n_electrodes - 1))
        ]
        if rx:
            sources.append((i, i + 1))
            receivers.append(rx)
    return sources, receivers


class Pseudosection(NamedTuple):
    """Dipole-dipole pseudosection data.

    Flat arrays over all (source, receiver) measurements; ``pseudo_x`` /
    ``pseudo_z`` follow the standard plotting convention (midpoint of
    source/receiver centers, half their separation as depth) used by
    SimPEG's ``plot_pseudosection``.
    """

    potentials: np.ndarray       # (n_src, n_electrodes)
    potentials_stderr: np.ndarray
    src_index: np.ndarray        # (M,) source id per measurement
    a_index: np.ndarray          # (M,) current electrode indices
    b_index: np.ndarray
    m_index: np.ndarray          # (M,) potential electrode indices
    n_index: np.ndarray
    voltage: np.ndarray          # (M,) V_M - V_N
    voltage_stderr: np.ndarray   # (M,) correlated-walk upper bound
    apparent_resistivity: np.ndarray  # (M,) 2D line-source convention
    pseudo_x: np.ndarray         # (M,)
    pseudo_z: np.ndarray         # (M,)


def run_pseudosection(
    survey: "DCRSurvey",
    electrodes: np.ndarray,
    num_rx_per_src: int = 10,
    n_walks: int = 1000,
    max_steps: int = 500,
    eps: float = 0.9,
    seed: int = 0,
    options: SolverOptions = None,
) -> Pseudosection:
    """Full dipole-dipole sweep from ONE walker ensemble.

    Every source dipole of the survey line is estimated simultaneously:
    walk paths are independent of the source term, so the solver carries
    one accumulator row per source (see ``solver/state.py``) instead of
    re-walking per source — an O(n_src) saving no sequential solver gets.
    The survey's own ``current_a/current_b`` are ignored; sources come from
    the electrode line.
    """
    from ..problems.fields import gaussian_dipole

    electrodes = np.asarray(electrodes, np.float32)
    n_elec = len(electrodes)
    sources, receivers = dipole_dipole_pairs(n_elec, num_rx_per_src)
    # bury surface-overlapping current electrodes (see _bury_source)
    src_pos = np.asarray(
        [survey._bury_source(p) for p in electrodes], np.float32
    )
    source_fields = [
        gaussian_dipole(src_pos[a], src_pos[b], survey.current,
                        survey.source_width)
        for a, b in sources
    ]
    if options is None:
        options = survey_default_options()
    problem = survey.build_problem()
    # version-bumping setters, NOT raw attribute assignment: solvers key
    # their compiled-solve caches on problem.version, so raw mutation
    # would leave any solver already holding this problem silently stale
    problem.set_source_term(source_fields)
    if survey.source_mis:
        # one mixture covering every electrode of the line
        used = sorted({i for ab in sources for i in ab})
        problem.set_source_importance(GaussianMixture.from_components([
            (tuple(src_pos[i]), survey.source_width, 1.0) for i in used
        ]))

    solver = WoStSolver(problem, options)
    pts = electrodes.copy()
    on_surface = np.abs(pts[:, 1] - survey.surface_y) < survey.electrode_nudge
    pts[on_surface, 1] = survey.surface_y - survey.electrode_nudge
    res = solver.solve(pts, n_walks=n_walks, max_steps=max_steps, eps=eps,
                       seed=seed)
    # solve() squeezes to (n_elec,) when there is a single source field
    # (a 4-electrode line yields exactly one source dipole) — normalize
    # to the (n_src, n_elec) layout the measurement loop indexes
    u = np.atleast_2d(np.asarray(res.mean))
    u_err = np.atleast_2d(np.asarray(res.stderr))

    rows = {k: [] for k in ("src", "a", "b", "m", "n", "dv", "dverr",
                            "rho", "px", "pz")}
    for s, ((a, b), rx_list) in enumerate(zip(sources, receivers)):
        for (m, n) in rx_list:
            dv = u[s, m] - u[s, n]
            dverr = float(np.sqrt(u_err[s, m] ** 2 + u_err[s, n] ** 2))
            rho = apparent_resistivity_2d(
                np.asarray([dv]), survey.current,
                electrodes[a], electrodes[b],
                electrodes[m][None], electrodes[n][None],
            )[0]
            src_mid = 0.5 * (electrodes[a, 0] + electrodes[b, 0])
            rx_mid = 0.5 * (electrodes[m, 0] + electrodes[n, 0])
            rows["src"].append(s)
            rows["a"].append(a)
            rows["b"].append(b)
            rows["m"].append(m)
            rows["n"].append(n)
            rows["dv"].append(float(dv))
            rows["dverr"].append(dverr)
            rows["rho"].append(float(rho))
            rows["px"].append(0.5 * (src_mid + rx_mid))
            rows["pz"].append(-0.5 * abs(rx_mid - src_mid))
    return Pseudosection(
        potentials=u,
        potentials_stderr=u_err,
        src_index=np.asarray(rows["src"]),
        a_index=np.asarray(rows["a"]),
        b_index=np.asarray(rows["b"]),
        m_index=np.asarray(rows["m"]),
        n_index=np.asarray(rows["n"]),
        voltage=np.asarray(rows["dv"]),
        voltage_stderr=np.asarray(rows["dverr"]),
        apparent_resistivity=np.asarray(rows["rho"]),
        pseudo_x=np.asarray(rows["px"]),
        pseudo_z=np.asarray(rows["pz"]),
    )
