"""Multi-device data-parallel solve over a 1-D device mesh.

The reference is single-process, single-thread Python (SURVEY.md §2); this
module supplies its missing scale axis: walker slots are sharded over a 1D
``jax.sharding.Mesh`` with ``shard_map``, each device runs the *entire*
walk loop independently on its shard (walkers never communicate — no
per-iteration collectives, so device loops don't sync), and a single
``psum`` combines the per-point ``(sum, sum-of-squares, count)`` triples
at the end. Seeds are stratified per shard by folding the device index
into the RNG key. The mesh is 1-D in ``jax.devices()`` order: one process
drives every GPU of a host, which NVLink joins all to all, so no device
order matters. Several hosts run through the same mesh: call
:func:`initialize_distributed` on every process first (recipe in its
docstring; exercised end-to-end by the 2-process CPU mesh test in
``tests/test_multihost.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..problems.problem import Problem
from ..solver.state import init_state
from ..solver.wost import RawSolveOut, SolverOptions, WoStSolver

__all__ = ["ShardedWoStSolver", "make_mesh", "initialize_distributed"]


def initialize_distributed(coordinator_address: str,
                           num_processes: int,
                           process_id: int,
                           local_device_count: Optional[int] = None):
    """Join a multi-process job, then build meshes as usual.

    The four GPUs of one host need none of this: one process sees them
    all in ``jax.devices()``, and ``make_mesh(4)`` spans them. Several
    processes (one per host) run the SAME code as one: every process
    calls this once before any other JAX work, then ``make_mesh()``
    (which sees the GLOBAL device list) and ``ShardedWoStSolver`` behave
    exactly as in one process — walkers never communicate, so the only
    cross-process traffic is the final ``psum`` of per-point moment
    triples, at (n_src x n_points)-float sizes.

    Nothing infers the arguments from the environment: pass the
    coordinator's address (any free port), the process count and this
    process's index:

        # host 0                          # host 1
        initialize_distributed(           initialize_distributed(
            "10.0.0.1:1234", 2, 0)            "10.0.0.1:1234", 2, 1)
        solver = ShardedWoStSolver(prob, make_mesh())   # both hosts

    ``local_device_count`` forces the per-process VIRTUAL CPU device
    count (``jax_num_cpu_devices`` — must run before any backend use;
    used by the CPU multi-process test, ``tests/test_multihost.py``,
    which drives a REAL 2-process x 4-virtual-device mesh through this
    exact path). Returns the global device count.
    """
    if local_device_count is not None:
        jax.config.update("jax_num_cpu_devices", int(local_device_count))
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return len(jax.devices())


def make_mesh(n_devices: Optional[int] = None, axis: str = "walkers") -> Mesh:
    """1D device mesh over the walker axis (global devices: multi-host
    processes each see the full list after :func:`initialize_distributed`)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


class ShardedWoStSolver(WoStSolver):
    """WoStSolver with walker slots sharded across a device mesh.

    Geometry/coefficient fields are replicated (they are compile-time
    constants of the step); evaluation points are replicated; only the
    walker-slot axis is partitioned. Results are bitwise independent of
    the mesh size only up to RNG stratification (each shard uses its own
    fold of the seed), exactly like running independent chains per device.
    """

    def __init__(
        self,
        problem: Problem,
        mesh: Mesh,
        options: SolverOptions = SolverOptions(),
    ):
        super().__init__(problem, options)
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        # progress callbacks: supported on BOTH sharded paths (the
        # reference shows tqdm on its only path, WoStSolver.py:182, and
        # production pod solves are exactly the long ones). Device loops
        # stay collective-free, so device 0 reports its OWN shard's
        # walks-done scaled by the mesh size — exact at start and end,
        # approximate in between (shards drain at slightly different
        # rates). XLA path: jax.debug.callback every ~64 steps; Pallas
        # path: once per kernel launch.
        # compaction: honored on the sharded PALLAS path (in-graph lane
        # packing onto the kernel's per-block early exit — see
        # _build_solve_fn_pallas_sharded); the XLA-sharded builder warns
        # at build time (one while_loop per device touches every lane
        # every step, so packing cannot help there)

    def _platform(self) -> str:
        return self.mesh.devices.flat[0].platform

    def _slot_layout(self, n_points: int, n_walks: int):
        """Like the base layout but with K divisible by the mesh size."""
        n_dev = self.mesh.devices.size
        k_cap = max(1, n_walks // max(self.options.min_quota, 1))
        K = int(
            np.clip(self.options.target_slots // max(n_points, 1), 1, k_cap)
        )
        K = max(n_dev, (K // n_dev) * n_dev)
        from ..solver.split import reserve_quota_row

        frac = (self.options.split_reserve
                if self.options.split_threshold is not None else 0.0)
        return K, reserve_quota_row(n_walks, K, frac)

    def _build_solve_fn_uncached(
        self, n_points: int, n_walks: int, max_steps: int, eps: float
    ):
        if self._use_pallas():
            return self._build_solve_fn_pallas_sharded(
                n_points, n_walks, max_steps, eps
            )
        return self._build_solve_fn_xla_sharded(n_points, n_walks, max_steps, eps)

    def _build_solve_fn_xla_sharded(
        self, n_points: int, n_walks: int, max_steps: int, eps: float
    ):
        K, quota_row = self._slot_layout(n_points, n_walks)
        # the sharded state is slot-major (lane = slot * n_points + point,
        # from the jnp.tile layout in shard_body), so CRN uses the "repeat"
        # stream map; every shard holds all points, so per-shard key folds
        # keep streams slot-matched across points within each shard
        crn = (
            ("repeat", K, n_points)
            if self.options.common_random_numbers else None
        )
        max_quota = int(quota_row.max())
        step_cap = max_quota * (max_steps + 1) + 2
        step = self._make_step_core(eps, max_steps, crn=crn)
        axis = self.axis
        n_src = max(1, len(self.problem.source_fields))
        # cross-step alpha cache, exactly as the base XLA path
        # (solver/wost.py::_build_solve_fn_xla)
        use_cache = self.problem.use_delta_tracking
        if use_cache:
            from ..solver.wost import _lift

            alpha0_v = jax.vmap(_lift(self.problem.alpha_c))
        use_split = (
            self.options.split_threshold is not None
            and self.problem.use_delta_tracking
            and self.options.rng == "fast"
        )
        if self.options.split_threshold is not None and not use_split:
            import warnings

            warnings.warn(
                "split_threshold is inert here: splitting applies to "
                "delta-tracking problems with rng='fast'.",
                stacklevel=3,
            )
        if self.options.compaction:
            import warnings

            warnings.warn(
                "compaction is ignored on the sharded XLA backend (one "
                "while_loop per device advances every lane every step, "
                "so lane packing cannot skip work); the sharded Pallas "
                "backend honors it via in-graph lane packing",
                stacklevel=3,
            )
        # lay slots out walker-major so the sharded axis is contiguous:
        # (K, n_points) with K split over devices
        quotas_km = jnp.asarray(np.tile(quota_row[:, None], (1, n_points)))
        # resolved eagerly: Problem.diameter's float() cannot run under
        # the shard_map trace
        snap_tol = self._boundary_snap_tol(eps)
        # sharded progress: device 0 reports its shard's walks-done
        # scaled by the mesh size (device loops stay collective-free)
        want_progress = self._progress_cb is not None
        n_dev_static = int(self.mesh.devices.size)
        total_walks = n_points * n_walks

        def _report(done_local, it):
            cb = self._progress_cb
            if cb is not None:
                cb(min(int(done_local) * n_dev_static, total_walks),
                   total_walks, int(it))

        def _wrap_dev0(stepfn, dev, quota_total):
            def wrapped(s, a, b, k, sid=None, **kw):
                s2, d = stepfn(s, a, b, k, sid=sid, **kw)
                jax.lax.cond(
                    (s2.step_idx % 64 == 0) & (dev == 0),
                    lambda done, it: jax.debug.callback(_report, done, it),
                    lambda done, it: None,
                    jnp.maximum(quota_total - jnp.sum(s2.quota), 0),
                    s2.step_idx,
                )
                return s2, d

            wrapped.lane_ids = stepfn.lane_ids
            return wrapped

        def shard_body(points, quotas_shard, key):
            # quotas_shard: (K/n_dev, n_points) on each device
            dev = jax.lax.axis_index(axis)
            shard_key = jax.random.fold_in(key, dev)
            k_local = quotas_shard.shape[0]
            # mark per-device state as axis-varying: the while-loop body
            # makes every carry component device-dependent, so the initial
            # carry must be too (shard_map vma typing)
            pv = lambda a: jax.lax.pcast(a, (axis,), to="varying")
            # boundary_snap (solver/wost.py::_snap_points): near-wall
            # evaluation points start every walk ON the Neumann wall with
            # the exact on-boundary half-ball machinery; points is
            # replicated, so the snap is too
            ptx, pty, ob0, n0x, n0y = self._snap_points(points, tol=snap_tol)
            p0x = pv(jnp.tile(ptx, (k_local,)))
            p0y = pv(jnp.tile(pty, (k_local,)))
            a0 = alpha0_v(p0x, p0y) if use_cache else None
            state = init_state(p0x, p0y, quotas_shard.reshape(-1),
                               n_src=n_src, a0=a0)
            state = state._replace(
                on_bdry=pv(state.on_bdry),
                nx=pv(state.nx),
                ny=pv(state.ny),
                atten=pv(state.atten),
                walk_acc=pv(state.walk_acc),
                steps_cur=pv(state.steps_cur),
                acc_sum=pv(state.acc_sum),
                acc_sumsq=pv(state.acc_sumsq),
                n_done=pv(state.n_done),
                total_steps=pv(state.total_steps),
                step_idx=pv(state.step_idx),
                trunc_n=pv(state.trunc_n),
                trunc_absw=pv(state.trunc_absw),
                wmax=pv(state.wmax),
                bmax=pv(state.bmax),
            )
            if ob0 is None:
                def step_s(s, a, b, k, sid=None):
                    return step(s, a, b, k, sid=sid, p0a=a0)

                step_s.lane_ids = step.lane_ids
            else:
                p0ob = pv(jnp.tile(ob0, (k_local,)))
                p0nx = pv(jnp.tile(n0x, (k_local,)))
                p0ny = pv(jnp.tile(n0y, (k_local,)))
                state = state._replace(on_bdry=p0ob, nx=p0nx, ny=p0ny)

                def step_s(s, a, b, k, sid=None):
                    return step(s, a, b, k, sid=sid,
                                p0ob=p0ob, p0nx=p0nx, p0ny=p0ny, p0a=a0)

                # _sharded_split_loop allocates lane stream ids via this
                step_s.lane_ids = step.lane_ids

            if want_progress:
                step_s = _wrap_dev0(step_s, dev, jnp.sum(quotas_shard))

            if not use_split:
                def cond(s):
                    return (s.step_idx < step_cap) & jnp.any(s.quota > 0)

                def body(s):
                    s2, _ = step_s(s, p0x, p0y, shard_key)
                    return s2

                final = jax.lax.while_loop(cond, body, state)
            else:
                final = self._sharded_split_loop(
                    step_s, state, p0x, p0y, shard_key, dev,
                    k_local, n_points, step_cap, max_steps,
                )
            if want_progress:
                # final report: short shards can drain before the first
                # in-loop %64 tick, and the end state is exact
                jax.lax.cond(
                    dev == 0,
                    lambda d_, i_: jax.debug.callback(_report, d_, i_),
                    lambda d_, i_: None,
                    jnp.maximum(jnp.sum(quotas_shard) - jnp.sum(final.quota),
                                0),
                    final.step_idx,
                )
            sums = final.acc_sum.reshape(n_src, k_local, n_points).sum(axis=1)
            sumsq = final.acc_sumsq.reshape(n_src, k_local, n_points).sum(axis=1)
            steps = final.total_steps
            # one collective per solve
            sums = jax.lax.psum(sums, axis)
            sumsq = jax.lax.psum(sumsq, axis)
            steps = jax.lax.psum(steps, axis)
            iters = jax.lax.pmax(final.step_idx, axis)
            trunc_n = jax.lax.psum(final.trunc_n, axis)
            trunc_absw = jax.lax.psum(final.trunc_absw, axis)
            wmax = jax.lax.pmax(final.wmax, axis)
            bmax = jax.lax.pmax(final.bmax, axis)
            done = (jnp.float32(jnp.nan) if use_split else jax.lax.psum(
                jnp.sum(final.n_done).astype(jnp.float32), axis))
            return (sums, sumsq, steps, iters, trunc_n, trunc_absw, wmax,
                    bmax, done)

        mapped = jax.shard_map(
            shard_body,
            mesh=self.mesh,
            in_specs=(P(), P(axis, None), P()),
            out_specs=(P(),) * 9,
        )

        @jax.jit
        def run(points, key):
            (sums, sumsq, steps, iters, trunc_n, trunc_absw, wmax,
             bmax, done) = mapped(points, quotas_km, key)
            mean = sums / n_walks
            var = jnp.maximum(sumsq / n_walks - mean * mean, 0.0)
            stderr = jnp.sqrt(var / n_walks)
            return RawSolveOut(
                mean=mean, stderr=stderr, walk_sum=sums, walk_sumsq=sumsq,
                total_steps=steps, iterations=iters,
                truncated_walks=trunc_n, truncated_weight=trunc_absw,
                max_weight=wmax, max_banked=bmax, finished_walks=done,
            )

        return run

    def _sharded_split_loop(self, step, state, p0x, p0y, shard_key,
                            dev, k_local, n_points, step_cap, max_steps):
        """Sweep while-loop, slot-major: in-graph high-weight splitting.

        The pairing/halving/stream-allocation logic is the shared
        ``solver/split.py`` helper (same implementation as the base
        solver's point-major split, viewed slot-major: the shard's state
        is ``lane = slot * n_points + point``, so heavy/idle pairing
        happens within each point's slot column).
        Per-lane stream ids ride in the carry; clone ids are allocated
        from a per-device range so shards never collide with each other
        or with the lane/CRN ids.
        """
        from ..solver.split import make_ingraph_split, run_split_while

        W_local = k_local * n_points
        # dev is already axis-varying, so deriving from it makes these
        # varying too (re-pcasting an already-varying value is an error).
        # Per-device clone ranges partition [2^30, 2^32) by the STATIC
        # mesh size — a fixed 2^24 stride overflowed uint32 at dev >= 192,
        # wrapping device 192's clone ids onto live lane/CRN stream ids
        n_dev = int(self.mesh.devices.size)
        stride = ((1 << 32) - (1 << 30)) // max(n_dev, 1)
        sid0 = step.lane_ids(W_local) + 0 * dev.astype(jnp.uint32)
        nsid0 = (jnp.uint32(1 << 30)
                 + dev.astype(jnp.uint32) * jnp.uint32(stride))
        do_split = make_ingraph_split(
            self.options.split_threshold, n_points, k_local,
            slot_major=True,
        )
        return run_split_while(
            step, do_split, state, p0x, p0y, shard_key,
            sid0, nsid0, step_cap, max_steps,
        )

    def _build_solve_fn_pallas_sharded(
        self, n_points: int, n_walks: int, max_steps: int, eps: float
    ):
        """shard_map around the fused Pallas launch loop: each device runs
        the multi-step kernel on its walker shard independently; one psum
        combines per-point sums at the end (same collective pattern as the
        XLA sharded path).

        High-weight splitting works here too: the launch-boundary split
        (``solver/split.py::make_launch_split`` — the same implementation
        the single-device Pallas host loop runs) executes IN-GRAPH between
        kernel launches inside each device's while-loop, with per-device
        clone stream ranges partitioning [2^30, 2^32) so shards never
        collide. The fast path carries the full variance-control set
        across chips (VERDICT r2 #4).
        """
        from ..ops.pallas_walk import make_pallas_walk, stream_ids

        opts = self.options
        pb = self.problem
        axis = self.axis
        n_dev = self.mesh.devices.size
        K, quota_row = self._slot_layout(n_points, n_walks)
        k_local = K // n_dev
        lane_block = opts.pallas_block_rows * 128
        w_local = n_points * k_local
        rows_local = max(
            opts.pallas_block_rows,
            ((w_local + lane_block - 1) // lane_block) * opts.pallas_block_rows,
        )
        w_pad = rows_local * 128
        n_inner = opts.pallas_inner_steps
        # slot-major shard layout (lane = slot * n_points + point): CRN
        # streams via the "repeat" map, like the sharded XLA path
        crn = (
            ("repeat", K, n_points)
            if opts.common_random_numbers else None
        )
        plan = make_pallas_walk(
            pb,
            eps=eps,
            max_steps=max_steps,
            t_min=opts.t_min_frac * pb.diameter,
            rmin=opts.rmin_factor * eps,
            project=opts.project_to_boundary,
            n_inner=n_inner,
            block_rows=opts.pallas_block_rows,
            rejection_rounds=opts.rejection_rounds,
            screened_sampler=opts.screened_sampler,
            max_attenuation=opts.max_attenuation,
            robin_correction=self._robin_enabled(),
            roulette_threshold=opts.roulette_threshold,
            robin_arrival_clamp=opts.robin_arrival_clamp,
            snap_starts=self._boundary_snap_tol(eps) is not None,
        )
        snap_tol = self._boundary_snap_tol(eps)
        sid_local = stream_ids(rows_local, crn)
        max_quota = int(quota_row.max())
        launch_cap = (max_quota * (max_steps + 1) + 2) // n_inner + 2
        n_src_p = max(1, len(pb.source_fields))
        use_split = (opts.split_threshold is not None
                     and pb.use_delta_tracking)
        if opts.split_threshold is not None and not use_split:
            import warnings

            warnings.warn(
                "split_threshold is inert here: splitting applies to "
                "delta-tracking problems (weights stay at 1.0 otherwise).",
                stacklevel=3,
            )
        if use_split:
            from ..solver.split import make_launch_split

            split_fn = make_launch_split(
                opts.split_threshold, n_src_p, n_points)
            # splits stop at launch_cap; the loop runs long enough after
            # that for every clone (remaining walk <= max_steps) to
            # finish, so no clone half-weight is truncated
            split_reserve = max_steps // n_inner + 1
        # Sharded compaction = IN-GRAPH lane packing: a shape-preserving
        # per-shard stable sort moves active lanes into the leading
        # kernel blocks, so drained trailing blocks hit the kernel's
        # per-block early exit and cost one load/store instead of
        # n_inner steps. Walk identity is untouched — stream ids, start
        # points, snap normals, and point ids all ride in the permuted
        # state (the same invariant as the single-device host-loop
        # compaction, which CAN shrink the grid because it lives outside
        # jit; inside the lockstep sharded while_loop shapes are static,
        # and packing captures the compute win without the reshape).
        use_pack = bool(opts.compaction)

        # sharded progress (one report per kernel launch from device 0,
        # scaled by the mesh size — see the class docstring note)
        want_progress = self._progress_cb is not None
        n_dev_static = int(self.mesh.devices.size)
        total_walks_p = n_points * n_walks

        def _report(done_local, it):
            cb = self._progress_cb
            if cb is not None:
                cb(min(int(done_local) * n_dev_static, total_walks_p),
                   total_walks_p, int(it))

        # quotas laid out (K, n_points) so the slot axis shards evenly
        quotas_km = jnp.asarray(
            np.tile(quota_row[:, None], (1, n_points)).astype(np.int32)
        )
        # per-shard point ids for the final segment sum
        pid_local = np.zeros((w_pad,), np.int32)
        pid_local[:w_local] = np.tile(
            np.arange(n_points, dtype=np.int32), k_local
        )
        pid_local_j = jnp.asarray(pid_local)

        def shard_body(points, quotas_shard, key):
            dev = jax.lax.axis_index(axis)
            # per-shard stream seed, derived exactly like the sharded XLA
            # path (fold the device index into the key); fixed across
            # launches — the kernel's per-lane counters advance the streams
            from ..sampling.rng import mix32

            shard_key = jax.random.fold_in(key, dev)
            kd = jnp.asarray(shard_key, jnp.uint32).reshape(-1)
            seed_i = jax.lax.bitcast_convert_type(
                kd[0] ^ mix32(kd[-1]), jnp.int32
            )
            pv = lambda a: jax.lax.pcast(a, (axis,), to="varying")
            # boundary_snap: near-wall evaluation points start ON the wall
            # (solver/wost.py::_snap_points; tol resolved eagerly — the
            # float() in Problem.diameter cannot run under the trace)
            ptx, pty, ob0, n0x, n0y = self._snap_points(points, tol=snap_tol)
            # slot-major layout matching pid_local: slot j of point i at
            # index j * n_points + i
            tile1 = lambda a, dt: pv(jnp.concatenate([
                jnp.tile(a.astype(dt), (k_local,)),
                jnp.zeros((w_pad - w_local,), dt),
            ]).reshape(rows_local, 128))
            p0x = tile1(ptx, jnp.float32)
            p0y = tile1(pty, jnp.float32)
            quota = jnp.concatenate([
                quotas_shard.reshape(-1),
                jnp.zeros((w_pad - w_local,), jnp.int32),
            ]).reshape(rows_local, 128)
            f0 = pv(jnp.zeros((rows_local, 128), jnp.float32))
            i0_ = pv(jnp.zeros((rows_local, 128), jnp.int32))
            state = {
                "p0x": p0x, "p0y": p0y, "sid": sid_local,
                "px": p0x, "py": p0y,
                "nx": f0, "ny": f0,
                "atten": f0 + 1.0,
                "quota": quota, "steps": i0_, "ndone": i0_, "ob": i0_,
                "life": i0_,
                "tn": f0, "tw": f0, "wmax": f0, "bmax": f0,
            }
            for i in range(n_src_p):
                state[f"acc{i}"] = f0
                state[f"asum{i}"] = f0
                state[f"asq{i}"] = f0
            if ob0 is not None:
                state["ob0"] = tile1(ob0, jnp.int32)
                state["n0x"] = tile1(n0x, jnp.float32)
                state["n0y"] = tile1(n0y, jnp.float32)
                state["ob"] = state["ob0"]
                state["nx"] = state["n0x"]
                state["ny"] = state["n0y"]

            # the launch loops' stop decision is GLOBAL (a psum'd
            # active-count flag carried from the previous iteration), not
            # per-device: every device must execute the same number of
            # pallas_call invocations — interpret mode takes a hard
            # cross-device barrier per call. Extra launches on an
            # early-drained device are ~free: the kernel's early exit
            # returns immediately when its quota is gone.
            def _global_active(state):
                return jax.lax.psum(
                    jnp.sum((state["quota"] > 0).astype(jnp.int32)), axis
                ) > 0

            q_total_local = jnp.sum(quota)

            def _emit_progress(st, launches):
                jax.lax.cond(
                    dev == 0,
                    lambda done, it: jax.debug.callback(_report, done, it),
                    lambda done, it: None,
                    jnp.maximum(q_total_local - jnp.sum(st["quota"]), 0),
                    launches * n_inner,
                )

            def pack(state, pid):
                # active lanes first (stable: relative walk order kept);
                # every per-lane array — including sid/p0/snap data and
                # the point ids — rides the same permutation, so walks
                # are identical and only block occupancy changes
                inactive = (state["quota"].reshape(-1) <= 0).astype(
                    jnp.int32)
                perm = jnp.argsort(inactive, stable=True)
                ns = {k: v.reshape(-1)[perm].reshape(v.shape)
                      for k, v in state.items()}
                return ns, pid[perm]

            if use_pack:
                state["sid"] = pv(state["sid"])

            if not use_split:
                def cond(c):
                    launches, g_active = c[2], c[3]
                    return (launches < launch_cap) & g_active

                def body(c):
                    state, pid, launches, _ = c
                    new_state = plan.run(state, seed_i)
                    if want_progress:
                        _emit_progress(new_state, launches + 1)
                    if use_pack:
                        new_state, pid = pack(new_state, pid)
                    return (new_state, pid, launches + 1,
                            _global_active(new_state))

                state, pid, launches, _ = jax.lax.while_loop(
                    cond, body,
                    (state, pv(pid_local_j), pv(jnp.int32(0)),
                     _global_active(state)),
                )
                bank_sum = jnp.zeros((n_src_p, n_points), jnp.float32)
                bank_sq = jnp.zeros((n_src_p, n_points), jnp.float32)
            else:
                # launch loop with the in-graph launch-boundary split:
                # after each kernel launch, heavy lanes clone into idle
                # lanes (any point: per-lane pid rides the carry, banked
                # stats accumulate in bank_sum/bank_sq). Per-device clone
                # stream ranges partition [2^30, 2^32) by the static mesh
                # size (the XLA sharded path's scheme; int32 lanes of the
                # kernel state hold the same bit patterns)
                n_dev_s = int(self.mesh.devices.size)
                stride = ((1 << 32) - (1 << 30)) // max(n_dev_s, 1)
                nsid0_u = (jnp.uint32(1 << 30)
                           + dev.astype(jnp.uint32) * jnp.uint32(stride))
                nsid0 = jax.lax.bitcast_convert_type(nsid0_u, jnp.int32)

                def cond(c):
                    launches, g_active = c[5], c[6]
                    return (launches < launch_cap + split_reserve) & g_active

                def body(c):
                    state, pid, nsid, bsum, bsq, launches, _ = c
                    state = plan.run(state, seed_i)
                    if want_progress:
                        _emit_progress(state, launches + 1)

                    def dosplit(state, pid, nsid, bsum, bsq):
                        state, pid, n, dsum, dsq = split_fn(
                            state, pid, nsid)
                        return (state, pid, nsid + n.astype(jnp.int32),
                                bsum + dsum, bsq + dsq)

                    state, pid, nsid, bsum, bsq = jax.lax.cond(
                        launches + 1 < launch_cap,
                        dosplit,
                        lambda *a: a,
                        state, pid, nsid, bsum, bsq,
                    )
                    if use_pack:
                        state, pid = pack(state, pid)
                    return (state, pid, nsid, bsum, bsq, launches + 1,
                            _global_active(state))

                # nsid0 derives from dev and is ALREADY axis-varying
                # (re-pcasting a varying value is an error); the others
                # are replicated constants that the loop body makes
                # device-dependent
                state, pid, _, bank_sum, bank_sq, launches, _ = \
                    jax.lax.while_loop(
                        cond, body,
                        (state, pv(pid_local_j), nsid0,
                         pv(jnp.zeros((n_src_p, n_points), jnp.float32)),
                         pv(jnp.zeros((n_src_p, n_points), jnp.float32)),
                         pv(jnp.int32(0)), _global_active(state)),
                    )
            sums = bank_sum + jnp.stack([
                jax.ops.segment_sum(
                    state[f"asum{i}"].reshape(-1), pid,
                    num_segments=n_points,
                )
                for i in range(n_src_p)
            ])
            sumsq = bank_sq + jnp.stack([
                jax.ops.segment_sum(
                    state[f"asq{i}"].reshape(-1), pid,
                    num_segments=n_points,
                )
                for i in range(n_src_p)
            ])
            steps = jnp.sum(state["life"].astype(jnp.float32))
            sums = jax.lax.psum(sums, axis)
            sumsq = jax.lax.psum(sumsq, axis)
            steps = jax.lax.psum(steps, axis)
            # executed critical-path live steps, not the issued budget
            # (matches the single-device Pallas paths — see RawSolveOut)
            iters = jax.lax.pmax(jnp.max(state["life"]), axis)
            trunc_n = jax.lax.psum(jnp.sum(state["tn"]), axis)
            trunc_w = jax.lax.psum(jnp.sum(state["tw"]), axis)
            wmax = jax.lax.pmax(jnp.max(state["wmax"]), axis)
            bmax = jax.lax.pmax(jnp.max(state["bmax"]), axis)
            done = (jnp.float32(jnp.nan) if use_split else jax.lax.psum(
                jnp.sum(state["ndone"]).astype(jnp.float32), axis))
            return (sums, sumsq, steps, iters, trunc_n, trunc_w, wmax,
                    bmax, done)

        mapped = jax.shard_map(
            shard_body,
            mesh=self.mesh,
            in_specs=(P(), P(axis, None), P()),
            out_specs=(P(),) * 9,
            check_vma=False,  # pallas_call outputs carry no vma metadata
        )

        @jax.jit
        def run(points, key):
            (sums, sumsq, steps, iters, trunc_n, trunc_w, wmax,
             bmax, done) = mapped(points, quotas_km, key)
            mean = sums / n_walks
            var = jnp.maximum(sumsq / n_walks - mean * mean, 0.0)
            stderr = jnp.sqrt(var / n_walks)
            return RawSolveOut(
                mean=mean, stderr=stderr, walk_sum=sums, walk_sumsq=sumsq,
                total_steps=steps, iterations=iters,
                truncated_walks=trunc_n, truncated_weight=trunc_w,
                max_weight=wmax, max_banked=bmax, finished_walks=done,
            )

        return run
