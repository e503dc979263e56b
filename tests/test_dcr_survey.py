"""Full DCR survey tests (config #5): MC forward model vs the FDM oracle.

Asserting rebuild of ``tests/testGeophysicalScenario.py`` (which only plots)
and the SimPEG notebook cross-check (C18; SimPEG replaced by the in-repo
finite-volume oracle on the identical conductivity model).
"""

import numpy as np
import pytest

from dcrmontecarlo_tpu.models import geophysical_scenario, notebook_survey
from dcrmontecarlo_tpu.solver import SolverOptions
from dcrmontecarlo_tpu.survey import (
    apparent_resistivity_2d,
    dipole_voltages,
    surface_electrode_line,
    survey_default_options,
)
from dcrmontecarlo_tpu.validation import fdm_solve


def test_surface_electrode_line():
    e = surface_electrode_line((-40, 40), 10.0)
    assert e.shape == (9, 2)
    assert e[0, 0] == -40 and e[-1, 0] == 40 and (e[:, 1] == 0).all()


def test_surface_electrode_line_never_overshoots():
    # Non-multiple extents must truncate, not round past x_range[1]: a
    # rounded count placed the last electrode up to spacing/2 OUTSIDE the
    # requested line (e.g. outside the domain walls)
    e = surface_electrode_line((-40, 44), 10.0)  # extent 84 = 8.4 spacings
    assert e[-1, 0] <= 44 + 1e-5
    assert e.shape[0] == 9  # -40 .. 40
    # exact multiples (incl. float-noise ratios) still reach the endpoint
    e2 = surface_electrode_line((-4.5, 4.5), 0.3)
    assert abs(e2[-1, 0] - 4.5) < 1e-5


def test_survey_default_options_are_measured_optima():
    # the shipped defaults are the knobs of the accuracy-calibration
    # table (THEORY.md §5, tools/calibration_table.py — 24 seeds,
    # one-knob-off arms vs the pinned Richardson oracle): CRN on,
    # roulette 0.05, rejection_rounds=2; compaction off (the adaptive
    # single kernel launch ends each block when its quota drains).
    from dcrmontecarlo_tpu.survey import survey_default_options

    o = survey_default_options()
    assert o.rejection_rounds == 2
    assert o.common_random_numbers and not o.compaction
    assert o.roulette_threshold == 0.05
    o2 = survey_default_options(compaction="pack", rejection_rounds=8)
    assert o2.compaction and o2.rejection_rounds == 8


def test_apparent_resistivity_homogeneous_recovers_rho():
    # In a homogeneous half-plane with line sources, rho_a == rho for any
    # electrode layout: build exact 2D potentials and invert.
    rho = 25.0
    current = 2.0
    a = np.array([-30.0, 0.0])
    b = np.array([30.0, 0.0])
    electrodes = surface_electrode_line((-20, 20), 5.0)

    def pot(p):
        ra = np.sqrt(((p - a) ** 2).sum())
        rb = np.sqrt(((p - b) ** 2).sum())
        return -current * rho / np.pi * (np.log(ra) - np.log(rb))

    v = np.array([pot(p) for p in electrodes])
    dv = dipole_voltages(v)
    rho_a = apparent_resistivity_2d(dv, current, a, b, electrodes[:-1], electrodes[1:])
    np.testing.assert_allclose(rho_a, rho, rtol=1e-10)


@pytest.fixture(scope="module")
def scenario_run():
    survey, electrodes = geophysical_scenario(sharpness=0.5)
    result = survey.run(
        electrodes,
        n_walks=1500,
        max_steps=800,
        eps=0.5,
        seed=0,
        options=SolverOptions(target_slots=16384),
    )
    prob = survey.build_problem()

    import jax

    alpha_v = jax.vmap(lambda x, y: prob.alpha(x, y))
    src_v = jax.vmap(lambda x, y: prob.source(x, y))

    def alpha_np(X, Y):
        return np.asarray(alpha_v(X.ravel(), Y.ravel())).reshape(X.shape)

    def source_np(X, Y):
        return np.asarray(src_v(X.ravel(), Y.ravel())).reshape(X.shape)

    fdm = fdm_solve(
        bounds=((-100.0, 100.0), (-200.0, 0.0)),
        alpha=alpha_np,
        source=source_np,
        neumann_top=True,
        nx=321,
        ny=321,
    )
    return result, fdm


def test_dcr_potentials_match_fdm(scenario_run):
    result, fdm = scenario_run
    ref = fdm(result.electrodes)
    err = np.abs(result.potentials - ref)
    tol = 4.0 * result.potentials_stderr + 2e-4  # MC error + eps-shell/grid bias
    ok = err < tol
    assert ok.mean() >= 8 / 9, (result.potentials, ref, result.potentials_stderr)


def test_dcr_voltage_antisymmetry(scenario_run):
    # The dipole is symmetric about x=2.5? No: +/-10 m dipole centered at 0,
    # but the conductivity anomalies break symmetry. Check only the sign
    # structure: potentials near the + electrode (x=-10) exceed those near
    # the - electrode (x=+10).
    result, _ = scenario_run
    v = result.potentials
    x = result.electrodes[:, 0]
    assert v[np.argmin(np.abs(x + 10))] > 0
    assert v[np.argmin(np.abs(x - 10))] < 0


def test_notebook_oracles_agree():
    # The reference's richest check is THIRD-PARTY FEM (SimPEG, notebook
    # cells 5-15) — structurally independent of the MC code. Here two
    # in-repo discretizations from different families (cell FVM with
    # harmonic faces + mirror ghosts vs nodal P1 FEM with centroid
    # coefficients + natural Neumann) are compared ON the flagship
    # notebook model: their electrode-potential disagreement bounds the
    # oracle error term of the flagship gate. Measured (2026-08-17):
    # max|fdm-fem| at the 21 electrodes = 0.152 (201^2), 0.0385 (401^2),
    # 0.0096 (801^2) — clean O(h^2) mutual convergence, ~40x below the
    # gate's MC slack.
    #
    # The oracle solves are PINNED (tools/gen_oracle_pins.py): this test
    # asserts on the committed numbers; the slow-marked
    # test_fdm_oracle.py::test_notebook_oracle_pins_regenerate rebuilds
    # them from scratch and compares, catching oracle or model drift.
    from dcrmontecarlo_tpu.validation import notebook_oracle_pins

    pins = notebook_oracle_pins()
    d = {n: np.abs(pins[f"fdm_{n}"] - pins[f"fem_{n}"]).max()
         for n in (201, 401)}
    assert d[401] < 0.08, d       # 2x headroom over the measured 0.0385
    assert d[201] / d[401] > 2.5, d  # mutual second-order convergence
    # Richardson consistency: the extrapolated limit must sit within the
    # 401-grid's own O(h^2) error of the 401 solution
    assert np.abs(pins["richardson"] - pins["fdm_401"]).max() < 0.25


def test_notebook_survey_matches_fdm_oracle():
    # C18 closed: the reference cross-validates its heterogeneous 1000 m
    # model against SimPEG FEM by eye (testNotebook.ipynb cells 13-21);
    # here the identical conductor (1e-1 @ (-120,-80) r=60) + resistor
    # (1e-3 @ (120,-80) r=60) model is ASSERTED against the in-repo
    # finite-volume oracle: electrode potentials within 4 sigma (+ small
    # FDM-grid/eps-shell allowance) and ALL adjacent dipole voltages — the
    # notebook's plotted observable (cell 21) — within 4 sigma.
    from dcrmontecarlo_tpu.validation import notebook_oracle_pins

    survey, electrodes = notebook_survey()
    assert electrodes.shape == (21, 2)
    survey.source_mis = True  # bounded NEE weights at the 1000 m scale
    # PINNED 401^2 FDM oracle (tools/gen_oracle_pins.py): the gate's
    # calibration (below) was measured against this exact reference, and
    # loading the pin cuts a sparse 401^2 solve from every CI run; the
    # slow-marked regeneration test catches oracle/model drift.
    pins = notebook_oracle_pins()
    np.testing.assert_allclose(pins["electrodes"], electrodes, atol=1e-5)
    ref = pins["fdm_401"]
    dv_ref = pins["dv_401"]

    # Config: the measured-optimal notebook pipeline (THEORY §4d/§4e/§4f)
    # — survey defaults (CRN + roulette + rejection_rounds=2)
    # plus local_majorant="auto" (2x err^2*t on absolute potentials),
    # the Robin chord chain auto-enabled (flagship scale s=0.119 > 0.05),
    # and round-5's unbiased high-weight splitting with reserved clone
    # hosts (split_threshold=4 + the split_reserve default): splitting
    # stabilizes the MEAN's heavy right tail (§4f resolution — the old
    # "chain offset" is median skew of a mean-unbiased estimator), which
    # halved the potentials slack this gate needs (6.49 -> 3.05 measured).
    #
    # Gate bounds calibrated on a 24-seed sweep at this exact config
    # (2026-08-20, tools/gate_sweep.py mode=r5; pinned in THEORY.md §5):
    # * ALL dipole voltages — the notebook's plotted observable (cell 21)
    #   — within 4 sigma + 0.25: dV excess over pure 4 sigma was ZERO at
    #   every electrode of every seed (the CRN stderr tracks the dV error
    #   tail; the 0.25 covers the measured 401^2 oracle error: FDM-vs-FEM
    #   mutual disagreement 0.0385, Richardson grid bias <=0.2).
    # * Potentials: >=19/21 within 4 sigma + 3.5 per seed (24-seed worst
    #   3rd-largest excess 3.05, max excess 10.9; seeds 0-2 measured
    #   21/19/20 at this slack). Down from +7.0 (round 4): the slack now
    #   covers the measured finite-n median skew, not an unexplained
    #   bias — the mechanism is identified (§4f RESOLVED: the estimator's
    #   EXPECTATION is unbiased — cap sweep -14.7 -> -0.2 as the cap
    #   lifts — and the per-seed median sits low because the balancing
    #   mass rides rare banked weights >= 1e3).
    # * Common-mode tripwire: the median signed potential error per seed
    #   sits in (-25, +3) — 24-seed measured range [-17.3, -1.5]; a chain
    #   regression blows past -25, a reversion to uncorrected reflection
    #   drifts positive past +3 (off-mode's wrong-BVP bias is ~+19, §4f).
    survey.local_majorant = "auto"
    solver = survey.make_solver(
        options=survey_default_options(target_slots=65536,
                                       split_threshold=4.0))
    for seed in (0, 1, 2):
        result = survey.run(
            electrodes,
            n_walks=2500,
            max_steps=6000,
            eps=1.0,
            seed=seed,
            solver=solver,
        )
        x = result.electrodes[:, 0]
        assert result.potentials[np.abs(x + 200) <= 40].mean() > 0
        assert result.potentials[np.abs(x - 200) <= 40].mean() < 0

        err = result.potentials - ref
        dev = np.abs(err) / (4.0 * result.potentials_stderr + 3.5)
        assert (dev < 1.0).sum() >= 19, (seed, result.potentials, ref, dev)

        cm = np.median(err)
        assert -25.0 < cm < 3.0, (seed, cm, err)

        dv_dev = np.abs(result.voltages - dv_ref) / (
            4.0 * result.voltages_stderr + 0.25
        )
        assert (dv_dev < 1.0).all(), (seed, result.voltages, dv_ref, dv_dev)


def test_dcr_apparent_resistivity_scale(scenario_run):
    # Background is 100 S/m = 0.01 ohm-m; anomalies perturb locally. The
    # apparent resistivity magnitude must sit within an order of magnitude
    # of the background for dipoles away from the current electrodes.
    # (Receiver dipoles touching the current electrodes at +-10 m — indices
    # 2..5 — have a degenerate geometric factor and are reported as NaN.)
    result, _ = scenario_run
    rho_bg = 1.0 / 1e2
    rho = result.apparent_resistivity
    assert np.isnan(rho[3]) and np.isnan(rho[4])
    outer = np.abs(np.concatenate([rho[:2], rho[-2:]]))
    assert (outer > rho_bg / 10).all() and (outer < rho_bg * 10).all(), rho


def test_survey_run_recovers_homogeneous_resistivity():
    # Regression for the surface-source current-burial bias: a Gaussian
    # current electrode centered exactly ON the Neumann surface loses half
    # its injected current outside the domain, biasing rho_a ~2x low.
    # build_problem must bury on-surface sources (as run_pseudosection
    # already did), so a homogeneous half-plane recovers rho = 1/sigma.
    from dcrmontecarlo_tpu.survey import DCRSurvey

    rho = 0.1
    survey = DCRSurvey(
        half_width=300.0, depth=600.0,
        current_a=(-30.0, 0.0), current_b=(30.0, 0.0),  # ON the surface
        conductivity=lambda x, y: 10.0 + 0.0 * x,
        source_width=0.5, source_mis=True,
    )
    electrodes = surface_electrode_line((-15.0, 15.0), 5.0)
    result = survey.run(
        electrodes, n_walks=5000, max_steps=1500, eps=0.25, seed=0,
        options=SolverOptions(target_slots=32768,
                              common_random_numbers=True),
    )
    med = float(np.nanmedian(result.apparent_resistivity))
    assert abs(med - rho) / rho < 0.25, (med, result.apparent_resistivity)


def test_build_problem_buries_surface_sources():
    from dcrmontecarlo_tpu.survey import DCRSurvey

    survey = DCRSurvey(
        half_width=100.0, depth=200.0,
        current_a=(-10.0, 0.0), current_b=(10.0, 0.0),
        conductivity=lambda x, y: 1.0 + 0.0 * x,
        source_width=0.5, source_mis=True,
    )
    prob = survey.build_problem()
    # the source density must peak at the buried positions (y = -1), with
    # ~no mass above the surface
    import jax

    f = prob.source
    assert float(f(-10.0, -1.0)) > 50.0 * abs(float(f(-10.0, 0.5)))
    # MIS importance centers follow the buried sources
    np.testing.assert_allclose(
        np.sort(np.asarray(prob.source_importance.cy)), [-1.0, -1.0]
    )
    # already-buried sources are left alone
    survey2 = DCRSurvey(
        half_width=100.0, depth=200.0,
        current_a=(-10.0, -5.0), current_b=(10.0, -5.0),
        conductivity=lambda x, y: 1.0 + 0.0 * x,
        source_width=0.5,
    )
    prob2 = survey2.build_problem()
    assert float(prob2.source(-10.0, -5.0)) > 50.0 * abs(
        float(prob2.source(-10.0, -1.0))
    )


def test_survey_solver_reuse():
    # make_solver + run(solver=...) reuses the compiled walk across calls
    from dcrmontecarlo_tpu.survey import DCRSurvey

    survey = DCRSurvey(
        half_width=100.0, depth=200.0,
        current_a=(-10.0, 0.0), current_b=(10.0, 0.0),
        conductivity=lambda x, y: 100.0 + 0.0 * x,
    )
    electrodes = surface_electrode_line((-20.0, 20.0), 10.0)
    solver = survey.make_solver(SolverOptions(target_slots=2048))
    r1 = survey.run(electrodes, n_walks=200, max_steps=300, eps=0.9,
                    seed=0, solver=solver)
    fn1 = next(iter(solver._solve_cache.values()))
    r2 = survey.run(electrodes, n_walks=200, max_steps=300, eps=0.9,
                    seed=1, solver=solver)
    assert np.isfinite(r1.potentials).all() and np.isfinite(r2.potentials).all()
    # same shapes -> the second run reuses the one compiled solve
    assert len(solver._solve_cache) == 1
    assert next(iter(solver._solve_cache.values())) is fn1
