"""Notebook audit with EVENT-SPLIT buckets (chain-vs-off decomposition).

Per-bucket means conditioned on the step's own outcome are NOT
individually zero even for an unbiased operator (NEE banks +, the
continuation nets -); the diagnostic is the CHAIN-OFF difference per
(pre-state, outcome) cell, which localizes which outcome's machinery
carries a residual.

usage: nb_audit2.py SEEDS STEPS MODE [SEED0] [NX] [W_LOG2]

env:
  NB_RAW=1      atten-WEIGHTED increments (est_t+1 - est_t, no /atten
                normalization). The normalized audit reads ~0 per bucket
                while the §4f offset persists — the leak rides the
                atten x residual correlation, which only the raw audit
                sees. Units: contribution to the electrode potential.
  NB_WINDOWS=n  split the K audited steps into n equal windows and
                report each (pre-state x outcome) cell per window —
                localizes WHEN in the walk the leak accrues.
  NB_CPU=1     force CPU (debug power only).
"""
import os, sys, time
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if os.environ.get("NB_CPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"


def main():
    import jax
    if os.environ.get("NB_CPU"):
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from dcrmontecarlo_tpu.models import notebook_survey
    from dcrmontecarlo_tpu.solver import SolverOptions
    from dcrmontecarlo_tpu.solver.state import init_state
    from dcrmontecarlo_tpu.solver.wost import WoStSolver
    from dcrmontecarlo_tpu.geometry import queries
    from dcrmontecarlo_tpu.validation import fdm_solve
    from dcrmontecarlo_tpu.diagnostics import grid_continuation

    S = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 48
    mode = sys.argv[3] if len(sys.argv) > 3 else "chain"
    SEED0 = int(sys.argv[4]) if len(sys.argv) > 4 else 0
    NXO = int(sys.argv[5]) if len(sys.argv) > 5 else 401
    WL2 = int(sys.argv[6]) if len(sys.argv) > 6 else 18
    PX = float(sys.argv[7]) if len(sys.argv) > 7 else 0.0
    PY = float(sys.argv[8]) if len(sys.argv) > 8 else -0.1
    ONB = bool(int(sys.argv[9])) if len(sys.argv) > 9 else False
    TMIN = float(sys.argv[10]) if len(sys.argv) > 10 else 1e-5

    survey, electrodes = notebook_survey()
    survey.source_mis = True
    prob = survey.build_problem()
    alpha_v = jax.vmap(lambda x, y: prob.alpha(x, y))
    src_v = jax.vmap(lambda x, y: prob.source(x, y))
    alpha_np = lambda X, Y: np.asarray(alpha_v(
        X.ravel().astype(np.float32), Y.ravel().astype(np.float32))
    ).reshape(X.shape)
    source_np = lambda X, Y: np.asarray(src_v(
        X.ravel().astype(np.float32), Y.ravel().astype(np.float32))
    ).reshape(X.shape)
    fdm = fdm_solve(bounds=((-500.0, 500.0), (-1000.0, 1.0)),
                    alpha=alpha_np, source=source_np,
                    neumann_top=True, nx=NXO, ny=NXO)
    cont = grid_continuation(fdm.xs, fdm.ys, fdm.u)

    kw = {"robin_correction": "chain" if mode != "off" else False}
    if mode == "refl":
        kw = {"robin_correction": "reflectance"}
    opts = SolverOptions(backend="xla", target_slots=1 << WL2,
                         rejection_rounds=2, t_min_frac=TMIN, **kw)
    solver = WoStSolver(prob, opts)
    eps, max_steps = 1.0, 6000
    step = solver._make_step_core(eps=eps, max_steps=max_steps)
    rmin = opts.rmin_factor * eps
    neumann, dirichlet = prob.neumann, prob.dirichlet
    n_src = max(1, len(prob.source_fields))

    W = 1 << WL2
    px0, py0 = PX, PY
    raw = bool(os.environ.get("NB_RAW"))
    NW = int(os.environ.get("NB_WINDOWS", "1"))
    # cells: prestate in {near(0), onb(1)} x outcome in
    # {branch(0), hit(1), collide(2), other(3)}; plus far(8), completing(9)
    NB = 10

    def run(key):
        p0x = jnp.full((W,), px0, jnp.float32)
        p0y = jnp.full((W,), py0, jnp.float32)
        ob_a = jnp.full((W,), ONB)
        nz = jnp.zeros((W,), jnp.float32)
        ny_a = jnp.full((W,), -1.0 if ONB else 0.0, jnp.float32)
        st = init_state(p0x, p0y, jnp.ones((W,), jnp.int32), n_src=n_src)
        st = st._replace(on_bdry=ob_a, ny=ny_a)

        def est_of(s):
            live = s.n_done < 1
            return jnp.where(live, s.walk_acc[0] + s.atten * cont(s.px, s.py),
                             s.acc_sum[0])

        def body(carry, t):
            s = carry
            pre_est = est_of(s)
            pre_live = s.n_done < 1
            dD = queries.distance(dirichlet, s.px, s.py)
            d_sil = queries.silhouette_distance(neumann, s.px, s.py)
            d_neu = queries.distance(neumann, s.px, s.py)
            r_pre = jnp.maximum(rmin, jnp.minimum(dD, d_sil))
            pre_att = s.atten
            s1, d = step(s, p0x, p0y, key, p0ob=ob_a, p0nx=nz, p0ny=ny_a)
            ok = pre_live & (jnp.abs(pre_att) > 1e-9)
            inc = jnp.where(ok, (est_of(s1) - pre_est)
                            / (1.0 if raw else pre_att), 0.0)
            outcome = jnp.where(
                d["evt_branch"], 0,
                jnp.where(d["evt_hit"], 1,
                          jnp.where(d["evt_collide"], 2, 3)))
            pre = jnp.where(s.on_bdry, 1, 0)
            bucket = pre * 4 + outcome
            bucket = jnp.where(~s.on_bdry & (d_neu >= r_pre), 8, bucket)
            bucket = jnp.where((s1.n_done >= 1) & pre_live, 9, bucket)
            bucket = bucket + NB * (t * NW // K)  # step-window offset
            live_f = ok.astype(jnp.float32)
            nbt = NB * NW
            sums = jnp.zeros((nbt,)).at[bucket].add(jnp.where(ok, inc, 0.0))
            sqs = jnp.zeros((nbt,)).at[bucket].add(
                jnp.where(ok, inc * inc, 0.0))
            cns = jnp.zeros((nbt,)).at[bucket].add(live_f)
            return s1, (sums, sqs, cns)

        _, (sums, sqs, cns) = jax.lax.scan(body, st, jnp.arange(K))
        return sums.sum(0), sqs.sum(0), cns.sum(0)

    run_j = jax.jit(run)
    names = ["near/branch", "near/hit", "near/collide", "near/other",
             "onb/branch", "onb/hit", "onb/collide", "onb/other",
             "far-int", "completing"]
    per_seed = []
    tot = np.zeros((3, NB * NW), np.float64)
    t0 = time.perf_counter()
    for k in range(S):
        key = jax.random.PRNGKey((SEED0 + k) * 7919 + 13)
        sm, sq, cn = run_j(key)
        sm = np.asarray(sm, np.float64); cn = np.asarray(cn, np.float64)
        per_seed.append(sm / np.maximum(cn, 1.0))
        tot += [sm, np.asarray(sq, np.float64), cn]
    per_seed = np.stack(per_seed)
    print(f"mode={mode} NX={NXO} W=2^{WL2} K={K} S={S} pt=({PX},{PY}) "
          f"onb={ONB} tmin={TMIN} raw={int(raw)} windows={NW} "
          f"t={time.perf_counter()-t0:.0f}s", flush=True)
    # per-WALKER totals per seed: the sum over cells of mean-inc * n/walk
    cell_contrib = per_seed * (tot[2] / W / S)
    tot_ps = cell_contrib.sum(axis=1)
    print(f"  TOTAL drift/walker over K steps: {tot_ps.mean():+.4f} "
          f"+- {tot_ps.std(ddof=1)/np.sqrt(S):.4f}", flush=True)
    for w in range(NW):
        if NW > 1:
            print(f"  -- window {w} (steps {w*K//NW}..{(w+1)*K//NW - 1}):",
                  flush=True)
        for i, nm in enumerate(names):
            j = w * NB + i
            if tot[2, j] == 0:
                continue
            m = tot[0, j] / tot[2, j]
            sem = per_seed[:, j].std(ddof=1) / np.sqrt(S)
            vpw = tot[2, j] / W / S
            print(f"  {nm:13s} n/walk {vpw:8.3f} mean-inc {m:+.5f} "
                  f"+- {sem:.5f} (contrib {m*vpw:+.4f})", flush=True)


main()
