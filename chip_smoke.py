"""Start-up check of the DCR survey solver on an NVIDIA GPU.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --chips 4   # four cards: the sharded phase only

Phases (one process, which opens the card once):

1. device — JAX must see a GPU; prints its kind, the device count, and the
   card's name and power limit from ``nvidia-smi``;
2. survey — the 1000 m notebook survey with the flagship gate's
   configuration through ``DCRSurvey.run`` for seeds 0-2, held to the
   gate's bounds against the pinned FDM oracle; then one
   ``run_pseudosection``;
3. throughput — ``bench.py``'s full ensemble: compile seconds, memory
   analysis, peak device memory and walker-steps/s;
4. kernel vs XLA — ``backend="xla"`` against ``backend="pallas"`` at the
   full, short and accuracy shapes, in turns (xla, pallas, pallas, xla),
   with a matched-seed comparison of the two;
5. the ``gpu``-marked tests, run by pytest in this process.

Any failed phase exits non-zero. The last line of stdout is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# the flagship gate's bounds (tests/test_dcr_survey.py)
DV_SLACK = 0.25        # every dV within 4 sigma + 0.25
POT_SLACK = 3.5        # potentials within 4 sigma + 3.5 ...
POT_MIN_OK = 19        # ... at >= 19 of 21 electrodes
CM_RANGE = (-25.0, 3.0)  # median signed potential error (common mode)


def log(*parts):
    print(*parts, flush=True)


def card_info():
    """``name, power.limit`` of each card, from nvidia-smi (a child that
    does not import JAX)."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip()


def device_phase(expect_count=None):
    import jax

    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        raise SystemExit(f"no GPU: JAX sees {d0.platform} {d0.device_kind}")
    if expect_count is not None and len(devs) < expect_count:
        raise SystemExit(f"need {expect_count} GPUs, JAX sees {len(devs)}")
    log(f"[device] platform={d0.platform} kind={d0.device_kind} "
        f"count={len(devs)}")
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(devs)}


def notebook_gate_survey():
    """The notebook survey with the flagship gate's configuration."""
    from dcrmontecarlo_tpu.models import notebook_survey

    survey, electrodes = notebook_survey()
    survey.source_mis = True
    survey.local_majorant = "auto"
    return survey, electrodes


def gate_options(**overrides):
    from dcrmontecarlo_tpu.survey import survey_default_options

    return survey_default_options(
        **{"target_slots": 65536, "split_threshold": 4.0, **overrides})


def survey_gate(potentials, stderr, voltages, voltages_stderr, pins):
    """The flagship gate's numbers for one seed; ``ok`` when all hold."""
    err = potentials - pins["fdm_401"]
    n_pot = int((np.abs(err) < 4.0 * stderr + POT_SLACK).sum())
    cm = float(np.median(err))
    dv_dev = np.abs(voltages - pins["dv_401"]) / (
        4.0 * voltages_stderr + DV_SLACK)
    ok = (n_pot >= POT_MIN_OK and CM_RANGE[0] < cm < CM_RANGE[1]
          and bool((dv_dev < 1.0).all()))
    return {"ok": ok, "potentials_ok": n_pot, "common_mode": cm,
            "max_dv_dev": float(dv_dev.max())}


def survey_phase(n_walks=2500, max_steps=6000, seeds=(0, 1, 2),
                 pseudo_walks=1000, options=None, enforce=True):
    from dcrmontecarlo_tpu.survey import run_pseudosection
    from dcrmontecarlo_tpu.validation import notebook_oracle_pins

    survey, electrodes = notebook_gate_survey()
    pins = notebook_oracle_pins()
    solver = survey.make_solver(options=options or gate_options())
    gates = []
    for seed in seeds:
        t0 = time.perf_counter()
        r = survey.run(electrodes, n_walks=n_walks, max_steps=max_steps,
                       eps=1.0, seed=seed, solver=solver)
        dt = time.perf_counter() - t0
        g = survey_gate(r.potentials, r.potentials_stderr, r.voltages,
                        r.voltages_stderr, pins)
        log(f"[survey] seed={seed} seconds={dt:.3f} "
            f"potentials_within={g['potentials_ok']}/{len(electrodes)} "
            f"common_mode={g['common_mode']:.3f} "
            f"max_dv_dev={g['max_dv_dev']:.3f} ok={g['ok']}")
        gates.append(g)
    if enforce and not all(g["ok"] for g in gates):
        raise AssertionError(f"survey gate failed: {gates}")
    t0 = time.perf_counter()
    ps = run_pseudosection(survey, electrodes, n_walks=pseudo_walks,
                           max_steps=max_steps, eps=1.0, seed=0)
    dt = time.perf_counter() - t0
    finite = bool(np.isfinite(ps.voltage).all()
                  and np.isfinite(ps.potentials).all())
    log(f"[survey] pseudosection sources={ps.potentials.shape[0]} "
        f"measurements={len(ps.voltage)} seconds={dt:.3f} finite={finite}")
    if not finite:
        raise AssertionError("pseudosection output is not finite")
    return gates


def _peak_bytes():
    """``peak_bytes_in_use`` per device (None where the platform keeps no
    allocator statistics, as the CPU does)."""
    import jax

    return [(d.memory_stats() or {}).get("peak_bytes_in_use")
            for d in jax.devices()]


def throughput_phase(case_kw=None, repeats=3, card=""):
    import jax

    from bench import full_case

    solver, pts, n_walks, max_steps, eps = full_case(**(case_kw or {}))
    fn = solver._build_solve_fn(len(pts), n_walks, max_steps, eps)
    key = jax.random.PRNGKey(0)
    t0 = time.perf_counter()
    compiled = fn.lower(pts, key).compile()
    compile_s = time.perf_counter() - t0
    log(f"[throughput] compile_seconds={compile_s:.3f}")
    log(f"[throughput] memory_analysis={compiled.memory_analysis()}")
    out = compiled(pts, key)
    jax.block_until_ready(out)
    steps, t0 = 0.0, time.perf_counter()
    for rep in range(repeats):
        out = compiled(pts, jax.random.PRNGKey(rep + 1))
        steps += float(out.total_steps)
    dt = time.perf_counter() - t0
    mean = np.asarray(out.mean)
    if not (np.isfinite(mean).all() and steps > 0):
        raise AssertionError(f"throughput ensemble: mean={mean} "
                             f"steps={steps}")
    log(f"[throughput] backend_used="
        f"{'pallas' if solver._use_pallas() else 'xla'} "
        f"walks={n_walks}x{len(pts)} steps_per_solve={steps / repeats:.6g} "
        f"seconds_per_solve={dt / repeats:.6f} "
        f"walker_steps_per_s={steps / dt:.6g} "
        f"peak_bytes_in_use={_peak_bytes()[0]} card={card}")
    return steps / dt


def agree(a, b, k=4.0):
    """Per-point means of two independent-stream estimates within
    ``k * sqrt(se_a^2 + se_b^2)``; returns the largest ratio."""
    tol = k * np.sqrt(np.asarray(a.stderr) ** 2 + np.asarray(b.stderr) ** 2)
    return float(np.max(np.abs(np.asarray(a.mean) - np.asarray(b.mean))
                        / np.maximum(tol, 1e-30)))


def _time_turn(fn, pts, reps, seed0):
    import jax

    steps, t0 = 0.0, time.perf_counter()
    for rep in range(reps):
        out = fn(pts, jax.random.PRNGKey(seed0 + rep))
        steps += float(out.total_steps)  # blocks on the result
    dt = time.perf_counter() - t0
    return dt / reps, steps / dt


def compare_backends(name, case, reps=3, **case_kw):
    """Time ``xla`` and ``pallas`` in turns on one case and check that
    they agree with matched seeds.

    Bit equality is not expected on the GPU: XLA and Triton contract
    FMAs and evaluate libdevice transcendentals differently, and a 1-ulp
    change can turn a trajectory. Everything is float32 elementwise (no
    matrix product, so TF32 plays no part), so the two are compared as
    estimates: equal finished walks, and each point's mean within
    4 sqrt(se_p^2 + se_x^2).
    """
    import jax
    import jax.numpy as jnp

    fns, res = {}, {}
    for backend in ("xla", "pallas"):
        solver, pts, n_walks, max_steps, eps = case(backend=backend,
                                                    **case_kw)
        pts = jnp.asarray(pts)
        fn = solver._build_solve_fn(len(pts), n_walks, max_steps, eps)
        t0 = time.perf_counter()
        res[backend] = jax.block_until_ready(fn(pts, jax.random.PRNGKey(0)))
        log(f"[kernel] shape={name} backend={backend} "
            f"compile_and_first_seconds={time.perf_counter() - t0:.3f}")
        fns[backend] = fn
    times = {"xla": [], "pallas": []}
    for turn, backend in enumerate(("xla", "pallas", "pallas", "xla")):
        s, rate = _time_turn(fns[backend], pts, reps, 1 + turn * reps)
        times[backend].append(s)
        log(f"[kernel] shape={name} backend={backend} turn={turn} "
            f"seconds_per_solve={s:.6f} walker_steps_per_s={rate:.6g}")
    x, p = res["xla"], res["pallas"]
    done = (float(x.finished_walks), float(p.finished_walks))
    ratio = agree(p, x)
    rel = float(np.max(np.abs(np.asarray(p.walk_sum)
                              - np.asarray(x.walk_sum)))
                / max(float(np.max(np.abs(np.asarray(x.walk_sum)))), 1e-30))
    log(f"[kernel] shape={name} finished_walks={done} "
        f"max_mean_dev_over_4sigma={ratio:.4f} "
        f"max_rel_walk_sum_diff={rel:.3g}")
    if done[0] != done[1] or not ratio < 1.0:
        raise AssertionError(f"{name}: backends disagree: walks={done} "
                             f"mean dev ratio={ratio}")
    return {"xla": float(np.mean(times["xla"])),
            "pallas": float(np.mean(times["pallas"]))}


KERNEL_SHAPES = {"full": {}, "short": {}, "accuracy": {}}


def kernel_phase(shapes=None, reps=3):
    from bench import accuracy_case, full_case, short_case

    cases = {"full": full_case, "short": short_case,
             "accuracy": accuracy_case}
    out = {}
    for name, kw in (shapes or KERNEL_SHAPES).items():
        out[name] = compare_backends(name, cases[name], reps=reps, **kw)
    faster = all(t["pallas"] < t["xla"] for t in out.values())
    log(f"[kernel] pallas faster at every shape: {faster}")
    return out


def gpu_tests_phase():
    import pytest

    rc = pytest.main([os.path.join(ROOT, "tests"), "-m", "gpu", "-q",
                      "-p", "no:cacheprovider", "-p", "no:randomly",
                      "--rootdir", ROOT])
    log(f"[gpu-tests] pytest exit={int(rc)}")
    if rc != 0:
        raise AssertionError(f"gpu-marked tests failed (exit {int(rc)})")


def _shard_placement(solver, n_points, n_walks):
    """Walker-slot rows each device holds: the solver shards its
    ``(K, n_points)`` slot table along K."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    K, _ = solver._slot_layout(n_points, n_walks)
    table = jax.device_put(
        np.zeros((K, n_points), np.int32),
        NamedSharding(solver.mesh, P(solver.axis, None)))
    return [(str(s.device), s.index[0].start, s.index[0].stop)
            for s in table.addressable_shards]


def sharded_phase(n_dev, n_walks=2500, max_steps=6000, survey_options=None,
                  full_kw=None):
    """ShardedWoStSolver on ``n_dev`` devices against the one-device solve
    of the same ensemble, for both backends: the notebook survey (its
    ``split_threshold=4`` runs the sharded split) and the throughput
    ensemble. Also a one-device mesh against WoStSolver."""
    from bench import full_case
    from dcrmontecarlo_tpu.parallel import ShardedWoStSolver, make_mesh
    from dcrmontecarlo_tpu.solver import WoStSolver
    from dcrmontecarlo_tpu.validation import notebook_oracle_pins

    import dataclasses

    survey_kw = {"n_walks": n_walks, "max_steps": max_steps}
    mesh = make_mesh(n_dev)
    pins = notebook_oracle_pins()
    survey, electrodes = notebook_gate_survey()
    problem = survey.build_problem()
    pts = np.asarray(electrodes, np.float32).copy()
    pts[:, 1] = survey.surface_y - survey.electrode_nudge
    opts = gate_options(**(survey_options or {}))
    for backend in ("xla", "pallas"):
        o = dataclasses.replace(opts, backend=backend)
        one = WoStSolver(problem, o).solve(pts, eps=1.0, seed=0,
                                           **survey_kw)
        t0 = time.perf_counter()
        sharded = ShardedWoStSolver(problem, mesh, o)
        many = sharded.solve(pts, eps=1.0, seed=0, **survey_kw)
        dt = time.perf_counter() - t0
        dv = many.mean[:-1] - many.mean[1:]
        dv_se = np.sqrt(many.stderr[:-1] ** 2 + many.stderr[1:] ** 2)
        g = survey_gate(many.mean, many.stderr, dv, dv_se, pins)
        ratio = agree(many, one)
        log(f"[sharded] survey backend={backend} devices={n_dev} "
            f"seconds={dt:.3f} max_mean_dev_over_4sigma={ratio:.4f} "
            f"max_dv_dev={g['max_dv_dev']:.3f}")
        log(f"[sharded] slot placement "
            f"{_shard_placement(sharded, len(pts), n_walks)}")
        if not (ratio < 1.0 and g["max_dv_dev"] < 1.0):
            raise AssertionError(f"sharded survey ({backend}) disagrees")

        solver, fpts, n_walks, max_steps, eps = full_case(
            backend=backend, **(full_kw or {}))
        one = solver.solve(fpts, n_walks=n_walks, max_steps=max_steps,
                           eps=eps, seed=0)
        t0 = time.perf_counter()
        many = ShardedWoStSolver(solver.problem, mesh, solver.options).solve(
            fpts, n_walks=n_walks, max_steps=max_steps, eps=eps, seed=0)
        dt = time.perf_counter() - t0
        mesh1 = ShardedWoStSolver(solver.problem, make_mesh(1),
                                  solver.options).solve(
            fpts, n_walks=n_walks, max_steps=max_steps, eps=eps, seed=0)
        r4, r1 = agree(many, one), agree(mesh1, one)
        log(f"[sharded] throughput backend={backend} devices={n_dev} "
            f"seconds_incl_compile={dt:.3f} steps={many.total_steps:.6g} "
            f"max_mean_dev_over_4sigma={r4:.4f} "
            f"one_device_mesh_vs_solver={r1:.4f}")
        if not (r4 < 1.0 and r1 < 1.0):
            raise AssertionError(f"sharded throughput ({backend}) "
                                 "disagrees")
    peaks = _peak_bytes()[:n_dev]
    log(f"[sharded] peak_bytes_in_use per device={peaks}")
    if any(p is not None for p in peaks) and not all(
            p is not None and p > 0 for p in peaks):
        raise AssertionError("a device holds no walker state")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    info = card_info()  # before JAX opens the card
    from bench import configure_compile_cache

    configure_compile_cache()
    device = device_phase(expect_count=args.chips)
    log(f"[device] card={info}")
    if args.chips == 4:
        sharded_phase(4)
    else:
        survey_phase()
        throughput_phase(card=info)
        kernel_phase()
        gpu_tests_phase()
    log(f"[device] card={info}")
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
