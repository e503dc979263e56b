"""Batched Walk-on-Stars solver (JAX rebuild of C10,
``solvers/WoStSolver.py:162-353``).

The reference runs three nested interpreted loops — points x walks x steps
(``WoStSolver.py:182,187,206``) — at O(1e3-1e4) walker-steps/s on CPU.
Here ONE ``lax.while_loop`` advances every walker of every evaluation point
simultaneously: the loop body is a fully branchless SoA step (every
reference ``if`` becomes ``jnp.where``/mask algebra), RNG is a counter-based
hash keyed on the global iteration index (threefry optional), and walker
slots recycle into their next walk the iteration after one terminates.

Algorithm per step (reference semantics with documented fixes, SURVEY §5):

1. closest-point query on the Dirichlet boundary; walks terminate when the
   distance <= eps (computed *before* the first check, fixing the
   ``eps=1.0`` zero-step degeneracy of ``WoStSolver.py:190,206``) or at
   ``max_steps``; the Dirichlet BC is evaluated at the walker position
   optionally *projected to the boundary* (improvement over
   ``WoStSolver.py:295``).
2. star radius ``r = max(rmin, min(d_dirichlet, d_silhouette))``
   (``WoStSolver.py:208-215``).
3. direction: uniform on the circle, or uniform on the *inward-normal
   centered* half-circle when standing on the Neumann boundary (fixing the
   90-degree-rotated, winding-dependent hemisphere of
   ``WoStSolver.py:226-228``).
4. next point = first ray hit on the Neumann boundary within ``r``
   (true ray parameter; fixes ``PolylinesSimple.py:123-132``).
5. source next-event estimation with exact Green's-weighted radius
   sampling (fixes the biased caches of ``solvers/utils.py:138-195``),
   clamped to the star region like ``WoStSolver.py:248-250``.
6. delta-tracking move (``WoStSolver.py:271-284``): interior event with
   probability ``sigma_bar * |G_s|``, branchless attenuation update. An
   interior-sampled radius that reaches the Neumann hit is a WALL ARRIVAL
   (the collision would have been outside the domain): it moves to the hit
   point with the edge weight and the on-boundary flag — the
   star-restricted Green's identity. The reference instead lets such
   walkers tunnel through the surface and random-walk the unbounded
   exterior (its notebook's "walk appears to be escaping" TODO), which
   biases 1000 m-scale DCR potentials 2-4x low.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..geometry import queries
from ..ops.greens import (
    greens_2d,
    greens_norm_2d,
    screened_chord_integral,
    screened_greens_2d,
    screened_greens_norm_2d,
    screened_greens_wall_ratio,
    screened_interior_prob,
)
from ..problems.problem import Problem
from ..sampling.radial import (
    sample_greens_radius,
    sample_screened_radius_transport,
)
from ..sampling.rng import counter_uniform, counter_uniform_lanes, mix32
from .state import WalkerState, init_state

__all__ = ["WoStSolver", "SolveResult", "SolverOptions", "RawSolveOut"]


def _lift(f: Callable) -> Callable:
    """Make a scalar field safe under vmap (force output to depend on x)."""

    def g(x, y):
        return jnp.asarray(f(x, y), jnp.float32) + 0.0 * x

    return g


@dataclass(frozen=True)
class SolverOptions:
    """Solver-level knobs (solve-call knobs are ``solve()`` arguments)."""

    target_slots: int = 65536          # walker-slot batch target (W)
    project_to_boundary: bool = True   # evaluate BC at the projected point
    t_min_frac: float = 1e-5           # min first-hit ray parameter / diameter
    rmin_factor: float = 0.5           # rmin = rmin_factor * eps (WoStSolver.py:167)
    screened_sampler: str = "exact"    # "exact": two-regime rejection
                                       # (weight 1 on acceptance; cost =
                                       # rejection_rounds redraw rounds) or
                                       # "transport": fitted monotone
                                       # transport map + exact importance
                                       # weight (loop-free, one draw per
                                       # sample; weight spread E[(w-1)^2]
                                       # <= 3e-5 — sampling/radial.py::
                                       # sample_screened_radius_transport).
                                       # Both are exactly unbiased and run
                                       # on BOTH backends with identical
                                       # draws.
    rejection_rounds: int = 64         # redraw cap of the screened-radius
                                       # rejection. The loop exits when the
                                       # whole block accepts, so its cost is
                                       # the block MAX. ANY cap is exactly
                                       # UNBIASED: a lane that exhausts its
                                       # rounds takes the final envelope
                                       # candidate with the closed-form
                                       # importance weight A(x)/a(z) folded
                                       # into the walker weight (see
                                       # sampling/radial._exact_rejection).
                                       # Small caps trade a little weight
                                       # variance on the few fallback lanes
                                       # for fewer rounds (cap 4: <=4% of
                                       # draws weighted at the worst-case
                                       # z~2).
    min_quota: int = 4                 # min walks per recycled slot; amortizes
                                       # the walk-length straggler tail
    common_random_numbers: bool = False  # slot-matched RNG streams across
                                       # evaluation points: correlates walks
                                       # from different points so voltage
                                       # DIFFERENCES (dipole receivers)
                                       # cancel most MC noise; requires
                                       # rng='fast'; works on both backends
    roulette_threshold: float = None   # low-weight Russian roulette: a
                                       # stepping walker whose |weight|
                                       # falls below the threshold survives
                                       # with probability |w|/threshold at
                                       # weight sign(w)*threshold, else its
                                       # walk terminates immediately
                                       # (keeping only what it already
                                       # accumulated). Exactly unbiased —
                                       # the survivor upweight carries the
                                       # killed walks' expected boundary
                                       # term — and cuts the steps spent
                                       # walking negligible weights to the
                                       # Dirichlet shell on absorbing
                                       # problems (sigma > 0). None: off.
    split_threshold: float = None      # UNBIASED high-weight control: a
                                       # walker whose |weight| exceeds the
                                       # threshold is SPLIT — an idle lane
                                       # receives a copy of its walk state
                                       # with a fresh RNG stream, both
                                       # continue at half weight, and the
                                       # clone retires after finishing
                                       # this one walk. E[sum of halves]
                                       # equals the unsplit walk exactly,
                                       # so the mean stays unbiased while
                                       # the heavy tail of negative-
                                       # sigma' weight compounding is
                                       # clipped into parallel sub-walks.
                                       # Pallas backend: split between
                                       # kernel launches (every
                                       # pallas_inner_steps), sharded or
                                       # not. XLA backend:
                                       # split in-graph every 16 steps,
                                       # paired within each point's slot
                                       # block (delta-tracking problems,
                                       # rng='fast'; the sharded XLA path
                                       # splits too — slot-major column
                                       # pairing with per-device clone
                                       # stream ranges). Caveats:
                                       # stderr
                                       # becomes a mild underestimate
                                       # when split pieces correlate
                                       # (pieces enter sumsq separately),
                                       # and CRN lane matching does not
                                       # extend to clones. None: off.
    split_reserve: float = 0.25        # fraction of each point's slots
                                       # that start IDLE (quota 0) as
                                       # clone hosts when split_threshold
                                       # is set (inert otherwise). The
                                       # split can only fire when an idle
                                       # lane exists in the point's
                                       # group; with every lane active at
                                       # start, EARLY heavy walks escape
                                       # splitting entirely (round-5
                                       # measurement: max banked |walk|
                                       # 6e5 on the cylinder gate WITH
                                       # split_threshold=4 — the tail the
                                       # split exists to clip rode
                                       # through starved sweeps). Idle
                                       # slots are strided so slot-major
                                       # device sharding keeps work and
                                       # clone capacity balanced per
                                       # shard. The same total walks run
                                       # on the working slots (quota is
                                       # redistributed, n_walks exact).
    max_attenuation: float = None      # optional walker-weight cap. Delta
                                       # tracking multiplies (1 - sigma'/
                                       # sigma_bar) per collision; where
                                       # sigma' is strongly NEGATIVE (e.g.
                                       # sharp diffusion bumps: sigma' =
                                       # sigma/a + (lap a/a - |grad ln a|^2
                                       # /2)/2 dips below -2) the weight
                                       # exceeds 1 and rare walks compound
                                       # it exponentially — finite mean,
                                       # heavy tail. The cap bounds the
                                       # estimator's variance at the cost
                                       # of a small controlled bias; None
                                       # (default) keeps it unbiased.
    robin_correction: object = "auto"  # Robin boundary correction: the
                                       # sqrt-alpha transform turns
                                       # zero-flux u into a Robin condition
                                       # for u~ (gamma = d ln sqrt(alpha)/
                                       # dn_out) that plain reflection
                                       # (False) ignores. Both modes weight
                                       # wall arrivals by
                                       # 1 + gamma G_s/|dG_s/dn| (4a); they
                                       # differ on the on-boundary flat
                                       # term (THEORY.md §4):
                                       # * True / "chain" — strictly
                                       #   unbiased signed CHORD branch:
                                       #   branch probability = the actual
                                       #   chord mass |c| = |4 gamma J(r)|
                                       #   (J = screened_chord_integral),
                                       #   point from a balanced log/
                                       #   exponential mixture, so branch
                                       #   weights are an O(1) density
                                       #   ratio. ~1x median error on
                                       #   the notebook survey AND ~4x
                                       #   smaller seed tail (THEORY.md
                                       #   §4e table;
                                       #   the pre-J q = |gamma|/
                                       #   sqrt(sigma_bar) scaling cost
                                       #   14x).
                                       # * ("residual" — the antithetic
                                       #   two-leg resummation — was
                                       #   REMOVED in round 4: measured
                                       #   worse than the chain on every
                                       #   workload (leg decoherence,
                                       #   THEORY.md §4e) while costing
                                       #   the hot step 3 RNG streams, a
                                       #   per-lane request buffer, and a
                                       #   clone-pair service. The
                                       #   negative result and the
                                       #   removed design are recorded in
                                       #   THEORY.md §4e; code in git
                                       #   history.)
                                       # * "reflectance" — deterministic
                                       #   resummation: the chord integral
                                       #   with u~ frozen at the walker is
                                       #   folded as a per-visit weight
                                       #   1/(1 - c), radii shrunk to
                                       #   bound |c|. Zero added variance,
                                       #   but the frozen-u~ residual is
                                       #   REAL when the solution varies
                                       #   along the wall within a chord
                                       #   (measured low on the 1000 m
                                       #   notebook survey, where chords
                                       #   span hundreds of meters) —
                                       #   exact only for u~ linear along
                                       #   the wall. Use on problems whose
                                       #   wall field is smooth at the
                                       #   chord scale.
                                       # "auto" (default): "chain" when
                                       # the probed bias scale
                                       # max_boundary_gamma * min(diameter,
                                       # 1/sqrt(sigma_bar)) exceeds 0.3,
                                       # else off. (The chain tames the
                                       # notebook's seed tail ~4x, but a
                                       # ~-10 common-
                                       # mode notebook offset is under
                                       # investigation — THEORY.md §4f —
                                       # so auto stays conservative.)
    robin_interior: str = "arrival"    # how chain mode realizes the Robin
                                       # wall term of INTERIOR walkers
                                       # (THEORY.md §4g):
                                       # * "arrival" (default) — the legacy
                                       #   per-arrival importance ratio
                                       #   1 + gamma rho / cos(phi), with
                                       #   cos(phi) clamped at
                                       #   robin_arrival_clamp. Bounded
                                       #   variance on every regime; the
                                       #   clamp drops a small amount of
                                       #   grazing-arrival Robin mass
                                       #   (bias shrinks with the clamp;
                                       #   on-boundary STARTS remove the
                                       #   dominant near-wall component).
                                       # * "chord" — strictly unbiased
                                       #   chord branch whenever the star
                                       #   ball overlaps the wall. Exact
                                       #   on MMS gates, but the no-branch
                                       #   upweight prod 1/(1-q) compounds
                                       #   e^{sum q} over a walk's wall
                                       #   residence: use ONLY where walks
                                       #   are short / wall residence is
                                       #   low (sum q <~ 1) — on the 1000 m
                                       #   survey's wall-hugging walks it
                                       #   measured 1e3..1e5-scale weight
                                       #   blowups.
    robin_arrival_clamp: float = 0.02  # grazing cos(phi) floor of the
                                       # "arrival" realization (variance/
                                       # residual-bias trade). Measured on
                                       # the strongly-screened near-wall
                                       # MMS with snapped starts (16x30k,
                                       # 2026-08-17): bias -1.1 at 0.3,
                                       # -0.55 at 0.1, -0.33 at 0.02,
                                       # plateau -0.3 at 0.005 — with NO
                                       # measurable stderr cost at any
                                       # clamp (boundary_snap removed the
                                       # grazing-start variance driver),
                                       # so the default sits at the bias
                                       # plateau's knee.
    boundary_snap: object = "auto"     # evaluation points within this
                                       # distance of a Neumann wall are
                                       # SNAPPED onto it and start every
                                       # walk with the exact on-boundary
                                       # half-ball machinery (normals from
                                       # the segment frame). "auto" =
                                       # eps/2 (the walk's resolution
                                       # scale, like the Dirichlet
                                       # termination shell); None/0
                                       # disables. Replaces the reference's
                                       # interior electrode nudge
                                       # (notebook cell 19, y = -0.1),
                                       # whose first-step grazing arrivals
                                       # lost clamped Robin mass — the
                                       # dominant term of the -12
                                       # common-mode electrode offset
                                       # (THEORY.md §4g). All backends:
                                       # XLA base/split/sharded and the
                                       # fused kernel (snap_starts state).
    rng: str = "fast"                  # "fast" (per-lane counter hash,
                                       # sampling/rng.py; the only RNG the
                                       # fused kernel implements) or
                                       # "threefry" (jax.random; XLA
                                       # backend only)
    backend: str = "auto"              # "auto" | "pallas" | "xla": pallas
                                       # runs the fused multi-step walk
                                       # kernel (ops/pallas_walk.py, Triton
                                       # route, GPU only outside
                                       # interpret_mode); auto picks it on
                                       # the GPU when the geometry fits
                                       # the kernel and rng="fast"
    pallas_inner_steps: int = 256      # walk steps per kernel launch on
                                       # the launch-loop paths (launch
                                       # BOUNDARIES are where splitting /
                                       # packing / progress fire)
    adaptive_launches: bool = True     # plain fused-kernel path only
                                       # (no split/compaction/progress —
                                       # nothing needs launch boundaries):
                                       # issue ONE kernel launch whose
                                       # runtime step budget covers the
                                       # whole remaining quota bound and
                                       # let the per-block early exit end
                                       # each block exactly when its
                                       # quota drains. Walks are launch-
                                       # partitioning-invariant by RNG
                                       # design, so results are BIT-
                                       # IDENTICAL to the fixed-launch
                                       # loop (tested).
    pallas_block_rows: int = 1         # walker rows (x128 lanes) per kernel
                                       # block, a power of two, run at
                                       # one walker per thread up to 8
                                       # warps (PERF.md holds the
                                       # block-size sweep)
    compaction: object = False         # walker-lane compaction on the
                                       # kernel backend:
                                       # * False — none (default; the
                                       #   adaptive single launch already
                                       #   ends each block when its quota
                                       #   drains).
                                       # * "pack" — IN-GRAPH lane packing:
                                       #   after a launch whose active
                                       #   count halved since the last
                                       #   pack, a stable argsort permutes
                                       #   active lanes into the leading
                                       #   kernel blocks, so drained
                                       #   trailing blocks hit the
                                       #   kernel's per-block early exit.
                                       #   Walks are unchanged (stream
                                       #   ids/p0/pid ride the
                                       #   permutation); the solve stays
                                       #   end-to-end jittable. Setting
                                       #   "pack" disables the adaptive
                                       #   single launch; the sharded
                                       #   kernel path, which launches in
                                       #   a loop anyway, packs every
                                       #   launch.
                                       # * True (the host-driven grid-
                                       #   SHRINK loop) was removed in
                                       #   round 5. Passing True raises.

    def __post_init__(self):
        if self.compaction is True:
            raise ValueError(
                "compaction=True (the host-driven grid-shrink loop) was "
                "removed in round 5: the adaptive single launch ends "
                "each kernel block when its quota drains. Use the "
                "default compaction=False, or 'pack'.")


class RawSolveOut(NamedTuple):
    """Device-side output of every compiled solve fn.

    All solve builders (XLA, Pallas, sharded — ``_build_solve_fn*`` here
    and in ``parallel/mesh.py``) return this named structure instead of a
    positional tuple: a field added to one backend is added to all of
    them by construction, and consumers (``solve``, ``bench.py``,
    ``tools/``) read fields by name — the class of silent positional
    drift that broke both bench presets in round 3 (CLAUDE.md) cannot
    recur. Array fields are per-source ``(n_src, N)``; scalars are 0-d
    device arrays (or python floats on the host-driven Pallas loop).
    """

    mean: jnp.ndarray          # (n_src, N) MC estimate per point
    stderr: jnp.ndarray        # (n_src, N) empirical stderr of the mean
    walk_sum: jnp.ndarray      # (n_src, N) raw sum of walk totals
    walk_sumsq: jnp.ndarray    # (n_src, N) raw sum of squares
    total_steps: jnp.ndarray   # () active walker-steps executed
    iterations: jnp.ndarray    # () executed inner-step loop trips on the
                               # critical path: XLA = while-loop trips,
                               # Pallas = max per-lane live steps (within
                               # EXIT_CHECK of the kernel's trip count —
                               # trailing drain-check trips mutate nothing
                               # and are not counted). NOT the issued
                               # step budget (round-4 adaptive launches
                               # reported the ~100x-inflated bound here).
    truncated_walks: jnp.ndarray   # () walks ended by max_steps with
                                   # nonzero weight (NaN = not tracked)
    truncated_weight: jnp.ndarray  # () sum of |atten| those walks dropped
    max_weight: jnp.ndarray        # () max |atten| any stepping lane
                                   # reached (diagnostic; transient
                                   # excursions may decay before banking)
    max_banked: jnp.ndarray        # () max |walk total| any finished walk
                                   # banked (max over sources) — the
                                   # variance-domination tripwire read by
                                   # solve()'s guard
    finished_walks: jnp.ndarray = float("nan")  # () walks banked over
                                   # all lanes (n_points * n_walks when
                                   # the solve drained); NaN on split
                                   # solves, whose clones inherit their
                                   # parent's per-lane walk count


class SolveResult(NamedTuple):
    mean: np.ndarray        # (N,) MC estimate per evaluation point
    stderr: np.ndarray      # (N,) empirical standard error of the mean
    n_walks: int
    total_steps: float      # active walker-steps executed
    iterations: int         # executed inner-step loop trips on the
                            # critical path (max over lanes/devices of
                            # per-lane live steps; see RawSolveOut)
    walk_sum: np.ndarray = None    # (N,) raw sum of walk totals — exact
    walk_sumsq: np.ndarray = None  # (N,) raw sum of squares; lets
                                   # solve_stream combine batches exactly
    truncated_walks: float = None  # walks ended by max_steps while still
                                   # carrying weight (tracked on ALL
                                   # backends: XLA, Pallas, sharded)
    truncated_weight: float = None  # sum of |atten| those walks dropped —
                                    # the magnitude of the cap's silent
                                    # bias; compare against n_walks *
                                    # n_points
    max_weight: float = None        # max |atten| any stepping lane reached
                                    # during the solve (all backends).
                                    # Diagnostic only: delta-tracking
                                    # weights fluctuate both ways, so a
                                    # transient excursion that decays
                                    # before banking is harmless (the
                                    # round-4 guard warned on this and
                                    # cried wolf on blessed configs)
    max_banked: float = None        # max |walk total| any finished walk
                                    # banked (all backends, max over
                                    # sources). solve() warns when ONE
                                    # banked walk carries more than half
                                    # of its point's walk sum-of-squares:
                                    # then the reported stderr is
                                    # dominated by a single sample and
                                    # the unsampled tail is larger —
                                    # supercritical compounding
                                    # (robin_interior="chord" wall
                                    # residence, strongly negative
                                    # sigma' without splitting). Quiet
                                    # whenever split/roulette actually
                                    # control the banked tail.


class WoStSolver:
    """Walk-on-Stars Monte Carlo solver for
    ``-div(alpha grad u) + sigma u = f`` with mixed polyline boundaries.

    API mirror of reference ``WostSolver_2D`` (``solvers/WoStSolver.py:22``):
    construct from a :class:`Problem`, then ``solve(points, n_walks,
    max_steps, eps)``.
    """

    def __init__(self, problem: Problem, options: SolverOptions = SolverOptions()):
        self.problem = problem
        self.options = options
        if options.screened_sampler not in ("exact", "transport"):
            raise ValueError(
                "screened_sampler must be 'exact' (rejection) or "
                f"'transport' (map + IS weight); got {options.screened_sampler!r}"
            )
        self._solve_cache = {}
        self._robin_cache = None  # (problem.version, False | "chain")
        self._progress_cb = None  # set per-solve; read at CALL time by the
                                  # compiled fns' host trampolines, so
                                  # changing the callback between solves
                                  # does not recompile

    def _robin_enabled(self):
        """Resolve ``SolverOptions.robin_correction`` to a realization mode.

        Returns ``False`` (plain reflection), ``"chain"`` (strictly
        unbiased signed chord branch; legacy ``True``), or
        ``"reflectance"`` (deterministic chord resummation,
        THEORY.md §4c).

        Auto probes max |gamma| along the Neumann boundary and evaluates
        the dimensionless scale ``s = gamma * min(diameter,
        1/sqrt(sigma_bar))`` — the relative bias of plain reflection on
        boundary-dominated observables. Above ``s = 0.05`` auto enables
        the chord chain; below it the correction stays off (at tiny
        ``s`` the chord machinery — an extra segment scan and three hash
        streams per on-boundary step — costs real throughput for a bias
        far below MC noise). The chain is exact on the MMS stress gates,
        cuts the notebook's heavy cross-seed dV error tail ~4x
        (THEORY.md §4e), and at the flagship's s = 0.119 it is
        ALSO the better absolute-potential estimator: measured against
        the Richardson-extrapolated FDM oracle at 16 seeds x 4M
        walks/electrode (2026-08-18), plain reflection's
        per-electrode bias is +2..+124 (median +18, largest near the
        source dipole) while the chain's residual offset is -3..-15
        (median -6.4, ~3x smaller; its mechanism remains the open
        THEORY.md §4f item). The earlier 0.3 threshold predates that
        control measurement. ``"reflectance"`` (zero added variance, but
        biased when the solution varies along the wall within a chord)
        is never auto-selected — opt in explicitly on wall-smooth
        problems.
        """
        pb = self.problem
        mode = self.options.robin_correction
        if not mode:
            return False
        if mode == "residual":
            raise ValueError(
                "robin_correction='residual' was removed in round 4: the "
                "antithetic two-leg resummation measured strictly worse "
                "than the 'chain' realization on every workload "
                "(THEORY.md 4e records the design and the measurements). "
                "Use 'chain' (default under 'auto') or 'reflectance'."
            )
        if not (pb.use_delta_tracking and pb.neumann is not None):
            return False
        if mode == "reflectance":
            return mode
        if mode == "arrival-only":
            # DIAGNOSTIC arm (round-5 §4f leak localization): the Robin
            # ARRIVAL weight without any on-boundary flat-term
            # realization (no chord branch, no reflectance fold).
            # Deliberately incomplete physics — it drops the on-boundary
            # walkers' Robin mass — used to decompose chain bias into
            # arrival-weight vs chord-machinery components on problems
            # with an exact oracle (tests/test_cylinder_oracle.py,
            # THEORY.md §4f). XLA backend only.
            return mode
        if mode != "auto":
            return "chain"  # True / "chain" / other truthy values
        if self._robin_cache is not None and self._robin_cache[0] == pb.version:
            return self._robin_cache[1]
        gmax = pb.max_boundary_gamma()
        scale = gmax * min(pb.diameter, 1.0 / np.sqrt(max(pb.sigma_bar, 1e-30)))
        enabled = "chain" if scale > 0.05 else False
        self._robin_cache = (pb.version, enabled)
        return enabled

    def _warn_supercritical(self, max_banked: float, walk_sumsq,
                            n_walks: int):
        """Runtime guard for supercritical weight compounding.

        Delta-tracking weights multiply per step; options that make the
        compounding supercritical (``robin_interior="chord"`` on
        wall-hugging walks — measured 1e3..1e5-scale blowups on the
        notebook survey, THEORY.md §4g — or strongly negative sigma'
        without splitting) produce variance-dominated garbage means with
        no error message.

        Criterion (round 5 — the round-4 flat ``|atten| > 1e3 x split
        scale`` trigger fired on the repo's own sanctioned tests and the
        bench warmup, because transient weight excursions that decay
        before banking are harmless): warn only when the single heaviest
        BANKED walk carries more than 90% of the largest point's walk
        sum-of-squares. ``max_banked^2 <= sumsq[its point]`` always, so
        ``max_banked^2 > 0.9 * max(sumsq)`` implies one walk holds > 90%
        of its own point's variance mass — the reported stderr there is
        set by a single sample and the unsampled tail is bigger than
        what was seen. The 90% (not 50%) threshold distinguishes the
        supercritical signature (compounded weights SPAN DECADES, so the
        top bank dwarfs all others combined) from legitimate
        sparse-contribution estimators (rare near-source NEE banks of
        comparable size: a handful of similar hits at modest n_walks
        puts the top at 50-85% — measured 84% on the sanctioned
        topography test, 52% on the sharded snap test — with an honest
        stderr).

        Second condition — the warning stays quiet when ANY
        variance-control knob is configured (split_threshold,
        roulette_threshold, or max_attenuation). Measured reality
        (2026-08-20, CPU, this file's calibration runs): the tuned
        flagship config itself reaches top-share 0.89-0.99 with banked
        walks to 6e5 — heavy-tailed DCR estimators are top-1-dominated
        at production walk counts even in their CALIBRATED gates (the
        CRN stderr tracks the tail seed-by-seed; THEORY.md §5), so no
        moment-based threshold separates them from the provoked
        supercritical config (share 0.989). The honest demarcation is
        whether the user has engaged the taming knobs: with one on,
        residual top-heaviness is a known calibrated property and
        repeating the warning would train users to ignore it (the
        round-4 failure mode); with NONE on, domination is the
        signature of compounding nobody addressed — exactly when the
        pointer to the knobs is actionable.
        """
        o = self.options
        if (o.split_threshold is not None
                or o.roulette_threshold is not None
                or o.max_attenuation is not None):
            return
        if n_walks < 256:
            # Small ensembles are trivially "dominated": with the DCR
            # family's legitimately heavy-tailed per-walk banks (rare
            # near-source NEE hits), the top walk's share of a point's
            # sum-of-squares is O(1) with high probability at small n
            # regardless of whether the compounding is controlled — the
            # bare bench warmup (64 walks/point, a sanctioned config)
            # measured share ~1.0 (|bank| 3.83, sumsq 14.7, 2026-08-21).
            # Domination only carries a supercritical signal once it
            # SURVIVES a few hundred walks; the provoking test fires at
            # n_walks=512 (tests/test_diagnostics.py).
            return
        top = float(np.max(walk_sumsq)) if np.size(walk_sumsq) else 0.0
        if (np.isfinite(max_banked) and top > 0.0
                and max_banked * max_banked > 0.9 * top):
            import warnings

            warnings.warn(
                f"a single walk banked |total| = {max_banked:.3g}, more "
                "than half the worst point's walk sum-of-squares "
                f"({top:.3g}): that point's estimate and stderr are set "
                "by one sample (supercritical weight compounding). Tame "
                "it with SolverOptions.split_threshold (unbiased "
                "splitting), roulette_threshold (unbiased low-weight "
                "kill), or max_attenuation (biased cap); if "
                "robin_interior='chord' is set, switch back to "
                "'arrival' (THEORY.md 4g).",
                stacklevel=3,
            )

    # ------------------------------------------------------------------ #
    # step function                                                      #
    # ------------------------------------------------------------------ #

    def _make_step_core(self, eps: float, max_steps: int, crn=None):
        """Build the branchless SoA step: ``(state, p0x, p0y, key) -> state``.

        Also returns a per-step diagnostics dict for the history-tracing
        path (``diagnostics/history.py``); the while-loop driver discards
        it.

        ``crn``: optional ``(mode, period, reps)`` common-random-numbers
        layout — slot ``j`` of EVERY evaluation point draws the same
        uniforms, so walks from nearby points follow correlated paths and
        their *differences* (dipole voltages) cancel most MC noise.
        ``mode`` is "tile" for point-major slot layouts (lane = p*K + j)
        or "repeat" for slot-major ones (lane = j*P + p). Per-point
        estimates stay unbiased; quadrature-summed difference errors
        become conservative upper bounds.
        """
        pb = self.problem
        opts = self.options
        dirichlet = pb.dirichlet
        neumann = pb.neumann
        has_neumann = neumann is not None
        use_delta = pb.use_delta_tracking
        source_fields = pb.source_fields
        has_source = len(source_fields) > 0
        importance = pb.source_importance
        use_mis = has_source and importance is not None
        bc = jax.vmap(_lift(pb.bc_dirichlet))
        sources = [jax.vmap(_lift(f)) for f in source_fields]
        alpha_c = jax.vmap(_lift(pb.alpha_c)) if use_delta else None
        sigma_prime = jax.vmap(_lift(pb.sigma_prime)) if use_delta else None
        robin_mode = self._robin_enabled()
        # False | "chain" | "reflectance" | "arrival-only" (diagnostic)
        use_robin = bool(robin_mode)
        robin_chain = robin_mode == "chain"
        robin_arrival_only = robin_mode == "arrival-only"
        # chain mode's interior-walker realization (THEORY.md §4g)
        int_chord = robin_chain and self.options.robin_interior == "chord"
        if use_robin:
            grad_log_alpha_x = jax.vmap(_lift(
                lambda x, y: pb.grad_log_alpha(x, y)[0]))
            grad_log_alpha_y = jax.vmap(_lift(
                lambda x, y: pb.grad_log_alpha(x, y)[1]))
            # static branch-rate floor (a quarter of the probed wall max):
            # the chord-branch RATE must be positive wherever gamma(z)
            # along the chord is nonzero, even when gamma at the walker
            # itself vanishes (e.g. the notebook's symmetry point between
            # the two anomalies) — rating on |gamma(x)| alone silently
            # dropped those visits' chord mass (measured as part of a
            # ~-10-unit common-mode electrode bias, 32x30k seeds)
            gamma_floor = jnp.float32(0.25 * pb.max_boundary_gamma())
        sigma_bar = jnp.float32(pb.sigma_bar) if use_delta else None
        local_mj = pb.local_majorant if use_delta else None
        if local_mj is not None:
            sb_bg = jnp.float32(max(local_mj.sigma_bar_bg, 1e-12))
            # expected per-step progress scales (lengths): a ball of
            # radius R with majorant s advances ~min(R, 1/sqrt(s))
            mfp_bg = jnp.float32(
                1.0 / np.sqrt(max(local_mj.sigma_bar_bg, 1e-12)))
            mfp_gl = jnp.float32(1.0 / np.sqrt(max(pb.sigma_bar, 1e-30)))
        sampler_transport = opts.screened_sampler == "transport"
        rmin = jnp.float32(opts.rmin_factor * eps)
        eps_f = jnp.float32(eps)
        t_min = jnp.float32(opts.t_min_frac * pb.diameter)
        project = opts.project_to_boundary

        rng_fast = opts.rng == "fast"
        if crn is not None and not rng_fast:
            raise ValueError("common random numbers require rng='fast'")

        n_u = 8 if use_mis else 4
        if robin_chain:
            n_u = 11  # three extra streams for the on-boundary chord branch
            # (the reflectance mode is draw-free: no extra streams)

        def _lane_ids(W):
            # RNG stream id per lane: under CRN, slot j of every point maps
            # to the same stream
            ids = jnp.arange(W, dtype=jnp.uint32)
            if crn is None:
                return ids
            mode, period, reps = crn
            if mode == "tile":      # point-major layout: lane = p*K + j
                return ids % jnp.uint32(period)
            return ids // jnp.uint32(reps)  # slot-major: lane = j*P + p

        def step(state: WalkerState, p0x, p0y, key, sid=None,
                 p0ob=None, p0nx=None, p0ny=None, p0a=None):
            # sid: optional per-lane RNG stream ids overriding the static
            # lane layout — the split-enabled run loop threads them so
            # walker clones draw from fresh, collision-free streams
            # p0ob/p0nx/p0ny: optional ON-BOUNDARY start flags + inward
            # normals for lanes whose evaluation point sits on a Neumann
            # wall (boundary_snap): recycled walks restart with the exact
            # on-boundary step machinery instead of the legacy interior
            # nudge, whose first-step grazing arrivals carried the
            # clamp's Robin-mass loss (THEORY.md §4g)
            # p0a: per-lane alpha at the start points, for the cross-step
            # alpha cache (state.a_cur is not None); None recomputes
            W = state.px.shape[0]
            if rng_fast:
                kd = jnp.asarray(key, jnp.uint32).reshape(-1)
                seed32 = kd[0] ^ mix32(kd[-1])
                lane_ids = _lane_ids(W) if sid is None else sid
                # per-lane counter (walk#, step#): correlated streams
                # survive walk desynchronization, and sequences are
                # reproducible per walk
                ctr = (state.n_done.astype(jnp.uint32)
                       * jnp.uint32(max_steps + 2)
                       + state.steps_cur.astype(jnp.uint32))
                u = counter_uniform_lanes(seed32, ctr, n_u, lane_ids)
            else:
                step_key = jax.random.fold_in(key, state.step_idx)
                u = jax.random.uniform(step_key, (n_u, W))
            act = state.quota > 0

            # -- termination check (WoStSolver.py:206-208,294-298) -------- #
            dD, cx, cy = queries.closest_point(dirichlet, state.px, state.py)
            done_eps = dD <= eps_f
            walk_done = act & (done_eps | (state.steps_cur >= max_steps))
            if project:
                bx = jnp.where(done_eps, cx, state.px)
                by = jnp.where(done_eps, cy, state.py)
            else:
                bx, by = state.px, state.py
            contrib = state.walk_acc + bc(bx, by) * state.atten

            bank = walk_done
            # truncation accounting: walks the max_steps cap ended while
            # still carrying weight (roulette kills end with atten == 0
            # and are excluded); their dropped mass is the one silent
            # bias source in the estimator, so it is surfaced per solve
            truncated = walk_done & ~done_eps & (jnp.abs(state.atten) > 0.0)
            trunc_n = state.trunc_n + jnp.sum(truncated.astype(jnp.float32))
            trunc_absw = state.trunc_absw + jnp.sum(
                jnp.where(truncated, jnp.abs(state.atten), 0.0))
            acc_sum = state.acc_sum + jnp.where(bank, contrib, 0.0)
            acc_sumsq = state.acc_sumsq + jnp.where(bank, contrib * contrib, 0.0)
            # heaviest banked walk total (max over sources): the guard's
            # variance-domination tripwire — unlike wmax (stepping
            # |atten|), this only counts weight that actually reached an
            # accumulator, so transient excursions that decay before
            # banking stay quiet (round-5 guard fix)
            new_bmax = jnp.maximum(
                state.bmax,
                jnp.max(jnp.where(bank, jnp.abs(contrib), 0.0)))
            n_done = state.n_done + bank.astype(jnp.int32)
            quota = state.quota - bank.astype(jnp.int32)

            # -- recycle finished slots into their next walk -------------- #
            px = jnp.where(walk_done, p0x, state.px)
            py = jnp.where(walk_done, p0y, state.py)
            walk_acc = jnp.where(walk_done, 0.0, state.walk_acc)
            atten = jnp.where(walk_done, 1.0, state.atten)
            on_bdry = jnp.where(
                walk_done,
                False if p0ob is None else p0ob,
                state.on_bdry)
            # current normals: recycled on-boundary starts need their
            # start normal THIS step (the direction/chord blocks below
            # read it); other lanes keep the last-arrival normal
            if p0ob is None:
                cnx, cny = state.nx, state.ny
            else:
                cnx = jnp.where(walk_done, p0nx, state.nx)
                cny = jnp.where(walk_done, p0ny, state.ny)
            steps_cur = jnp.where(walk_done, 0, state.steps_cur)
            stepping = act & ~walk_done

            # -- star radius (WoStSolver.py:210-215) ---------------------- #
            if has_neumann:
                d_sil = queries.silhouette_distance(neumann, px, py)
                r = jnp.maximum(rmin, jnp.minimum(dD, d_sil))
            else:
                d_sil = jnp.full_like(dD, jnp.inf)
                r = jnp.maximum(rmin, dD)

            # -- two-level local majorant (problems/majorant.py) ---------- #
            # Deterministic per-position choice between (a) the full star
            # radius priced at the global majorant and (b) a ball shrunk
            # to exclude the high-sigma' regions priced at the background
            # majorant — whichever offers more expected progress
            # min(radius, 1/sqrt(sigma_bar)). Any radius below the star
            # bound with any ball-wide majorant is a valid delta-tracking
            # realization, so this is exactly unbiased.
            if use_delta and local_mj is not None:
                d_far = local_mj.distance(px, py)
                rB = jnp.minimum(r, d_far)
                useB = (d_far >= rmin) & (
                    jnp.minimum(rB, mfp_bg) > jnp.minimum(r, mfp_gl))
                r = jnp.where(useB, rB, r)
                sbar = jnp.where(useB, sb_bg, sigma_bar)
            else:
                sbar = sigma_bar

            if use_robin:
                # -- Robin chord mass (THEORY.md §4b/4c/4g) --------------- #
                # c = 4 gamma J(r) is the frozen-u~ mass of the flat-wall
                # chord term int_chord gamma 2 G_s(|zeta|) u~ dzeta
                # (J = screened_chord_integral). Both realizations bound it
                # by SHRINKING the on-boundary star radius until |c| <=
                # c_max — the per-step identity holds for any radius below
                # the silhouette bound, so this is exact, not a clamp.
                # * reflectance: fold the term deterministically as
                #   u~(x) = H / (1 - c) — every continuation weight
                #   (arrivals, collisions, AND this step's source NEE)
                #   carries 1/(1 - c). Zero added variance; residual bias
                #   is second order in the wall variation of u~ over the
                #   (shrunk) chord.
                # * chain: c sets the branch probability q = min(1/2, |c|)
                #   below, which makes the branch weight the O(1) density
                #   ratio G_s/(2 J p_mix) — strictly unbiased with NO
                #   exp-compounding weight spread. Chain mode additionally
                #   realizes the INTERIOR-walker wall term
                #   int_{wall cap B} gamma(z) G_s(|x-z|) u~(z) dz by the
                #   same branch machinery whenever the star ball overlaps
                #   the wall (d_w < r) — replacing the legacy grazing-
                #   arrival importance ratio 1 + gamma rho / cos(phi),
                #   whose cos(phi) >= 0.1 clamp DROPPED real Robin mass on
                #   near-wall walks (measured -8..-16 on a 100-scale MMS
                #   with electrodes hugging the wall; bias -> +0.1 as the
                #   clamp -> 0.01; THEORY.md §4g).
                c_max = 0.5
                if robin_chain:
                    # nearest wall point + the EXACT segment frame: the
                    # chord must lie ON the wall; deriving its direction
                    # from (x - foot)/d is f32-noisy and put chord points
                    # off the wall by |zeta| * err — walkers then escaped
                    # through the surface (measured: exp-field NaN blowup)
                    (d_w, wfx, wfy, wtx, wty,
                     s_lo, s_hi) = queries.closest_point_chord(
                        neumann, px, py)
                    d_wall = jnp.where(on_bdry, 0.0, d_w)
                    # normal = segment perpendicular, SIGN toward the
                    # walker (only the sign uses the noisy p - foot);
                    # on-boundary lanes keep their own arrival normal
                    dot_n = (px - wfx) * (-wty) + (py - wfy) * wtx
                    sgn_n = jnp.where(dot_n >= 0.0, 1.0, -1.0)
                    n_cx = jnp.where(on_bdry, cnx, sgn_n * (-wty))
                    n_cy = jnp.where(on_bdry, cny, sgn_n * wtx)
                    t_cx, t_cy = wtx, wty
                    fx = jnp.where(on_bdry, px, wfx)
                    fy = jnp.where(on_bdry, py, wfy)
                    if int_chord:
                        # cap the interior star radius at 3 d_wall: the
                        # per-step chord mass then VANISHES as the walker
                        # nears the wall (q ~ gamma d), so the no-branch
                        # upweight prod 1/(1 - q) stays bounded per
                        # APPROACH. (The sum over a whole walk's wall
                        # residence is still unbounded — hence this
                        # realization is opt-in, see robin_interior.)
                        r_cap = jnp.maximum(3.0 * d_wall, rmin)
                        r = jnp.where(
                            ~on_bdry & (d_wall < r),
                            jnp.minimum(r, r_cap), r)
                else:
                    n_cx, n_cy = cnx, cny
                    t_cx, t_cy = -cny, cnx
                    fx, fy = px, py
                    d_wall = jnp.zeros_like(px)
                glx0 = grad_log_alpha_x(px, py)
                gly0 = grad_log_alpha_y(px, py)
                gamma0 = -0.5 * (n_cx * glx0 + n_cy * gly0)
                # branch-rate magnitude: |gamma0| FLOORED at the static
                # gamma_floor so visits where gamma(x) ~ 0 still realize
                # their (gamma(z)-weighted) chord term; the shrink below
                # bounds it, which also bounds |c_ch| <= c_max for the
                # reflectance/residual folds (c_mag >= |c_ch| always)
                g_eff = jnp.maximum(jnp.abs(gamma0), gamma_floor)
                chord_j = screened_chord_integral(r, sbar)
                c_mag = 4.0 * g_eff * chord_j
                for _ in range(4):
                    shrink = on_bdry & (c_mag > c_max)
                    r_new = jnp.maximum(
                        rmin, r * (c_max / jnp.maximum(c_mag, 1e-12)))
                    r = jnp.where(shrink, r_new, r)
                    chord_j = jnp.where(
                        shrink, screened_chord_integral(r, sbar), chord_j)
                    c_mag = jnp.where(shrink, 4.0 * g_eff * chord_j, c_mag)
                c_ch = 4.0 * gamma0 * chord_j
                # rmin can floor the shrink; keep the factors bounded
                c_mag = jnp.where(on_bdry, jnp.minimum(c_mag, 0.9), 0.0)
                c_ch = jnp.where(
                    on_bdry, jnp.clip(c_ch, -0.9, 0.9), 0.0)
                if int_chord:
                    # interior chord half-length + branch rate. ANY
                    # positive rate is unbiased (the branch weight divides
                    # by it); exp(-d sqrt(sbar)) matches the kernel's
                    # distance decay so fired weights stay O(1), and the
                    # min(., 1/2) cap keeps the non-branch upweight
                    # 1/(1 - q) <= 2.
                    l_ch = jnp.sqrt(
                        jnp.maximum(r * r - d_wall * d_wall, 0.0))
                    j_int = screened_chord_integral(
                        jnp.maximum(l_ch, 1e-12), sbar)
                    c_int = (2.0 * g_eff * j_int
                             * jnp.exp(-d_wall * jnp.sqrt(
                                 jnp.maximum(sbar, 1e-12))))
                    c_int = jnp.where(
                        ~on_bdry & (d_wall < r) & (l_ch > 0.0),
                        jnp.minimum(c_int, 0.5), 0.0)
                if not robin_chain and not robin_arrival_only:
                    atten = jnp.where(
                        stepping & on_bdry, atten / (1.0 - c_ch), atten)

            # -- direction (WoStSolver.py:226-232; normal-centered fix) --- #
            # ONE sin/cos pair at phi = pi u serves both the free direction
            # (theta = 2 phi, double-angle) and the hemisphere rotation
            # (beta = pi (u - 1/2)) — same numerics as the Pallas kernel
            phi = jnp.pi * u[0]
            cphi = jnp.cos(phi)
            sphi = jnp.sin(phi)
            dx = 1.0 - 2.0 * sphi * sphi      # cos(2 phi)
            dy = 2.0 * sphi * cphi            # sin(2 phi)
            if has_neumann:
                cb = sphi
                sb = -cphi
                hdx = cnx * cb - cny * sb
                hdy = cny * cb + cnx * sb
                dx = jnp.where(on_bdry, hdx, dx)
                dy = jnp.where(on_bdry, hdy, dy)

            # -- next point (WoStSolver.py:235-239) ----------------------- #
            if has_neumann:
                # the t_min self-hit guard is only needed for walkers
                # standing ON the boundary (their own segment intersects at
                # t ~ 0); for free walkers any positive hit must count, or
                # a walker that lands within t_min of the surface tunnels
                # through it on its next step and escapes the domain
                t_min_w = jnp.where(on_bdry, t_min, 0.0)[:, None]
                hx, hy, hnx, hny, t_hit, hit = queries.first_hit(
                    neumann, px, py, dx, dy, r, t_min_w
                )
            else:
                hx = px + r * dx
                hy = py + r * dy
                hnx = jnp.zeros_like(px)
                hny = jnp.zeros_like(px)
                t_hit = r
                hit = jnp.zeros_like(on_bdry)

            # -- radial sample (exact; fixes solvers/utils.py:138-195) ---- #
            if use_delta:
                if rng_fast:
                    def draw_r(round_idx):
                        sd = (seed32 ^ jnp.uint32(0xA5A5A5A5)
                              ^ (jnp.asarray(round_idx).astype(jnp.uint32)
                                 * jnp.uint32(0x68E31DA4)))
                        return counter_uniform_lanes(sd, ctr, 4, lane_ids)

                    if sampler_transport:
                        # loop-free transport map + exact IS weight
                        r_s, w_rej = sample_screened_radius_transport(
                            draw_r, r, sbar)
                    else:
                        from ..sampling.radial import _exact_rejection

                        # finite redraw cap made exactly unbiased: lanes
                        # that exhaust rejection_rounds take their final
                        # envelope candidate with the importance weight
                        # A(x)/a(z), folded into the walker weight below
                        r_s, w_rej = _exact_rejection(draw_r, r, sbar,
                                                      opts.rejection_rounds,
                                                      with_weight=True)
                    atten = jnp.where(stepping, atten * w_rej, atten)
                elif sampler_transport:
                    rkey = jax.random.fold_in(step_key, 1)

                    def draw_tt(round_idx):
                        return jax.random.uniform(
                            jax.random.fold_in(rkey, round_idx),
                            (4,) + jnp.shape(r), minval=1e-7, maxval=1.0,
                        )

                    r_s, w_rej = sample_screened_radius_transport(
                        draw_tt, r, sbar)
                    atten = jnp.where(stepping, atten * w_rej, atten)
                else:
                    # threefry path: same weighted cap as the fast path
                    # (the cap contract — any rejection_rounds is exactly
                    # unbiased — holds on every backend)
                    from ..sampling.radial import _exact_rejection

                    rkey = jax.random.fold_in(step_key, 1)

                    def draw_t(round_idx):
                        return jax.random.uniform(
                            jax.random.fold_in(rkey, round_idx),
                            (4,) + jnp.shape(r), minval=1e-7, maxval=1.0,
                        )

                    r_s, w_rej = _exact_rejection(draw_t, r, sbar,
                                                  opts.rejection_rounds,
                                                  with_weight=True)
                    atten = jnp.where(stepping, atten * w_rej, atten)
            else:
                r_s = sample_greens_radius(r, u[1], u[2])
            beyond = r_s > t_hit  # clamp to star region (WoStSolver.py:248)
            sx = jnp.where(beyond, hx, px + r_s * dx)
            sy = jnp.where(beyond, hy, py + r_s * dy)

            if use_delta:
                if state.a_cur is not None:
                    # cross-step alpha cache: recycled lanes restart at p0
                    # (driver-supplied p0a, or a recompute that XLA hoists
                    # out of the loop — p0x/p0y are loop-invariant); every
                    # other lane carries the alpha its own move evaluated
                    # last step (a_s / a_h / a_z below).
                    a_p0 = alpha_c(p0x, p0y) if p0a is None else p0a
                    a_p = jnp.where(walk_done, a_p0, state.a_cur)
                else:
                    a_p = alpha_c(px, py)

            # -- source next-event estimation (WoStSolver.py:242-258) ----- #
            # one NEE sample shared by every source field: paths are
            # source-independent, so a multi-source survey reuses the
            # ensemble (accumulators carry an (n_src, W) leading axis)
            src_contrib = jnp.zeros_like(state.walk_acc)
            if has_source and not use_mis:
                f_val = jnp.stack([f(sx, sy) for f in sources])  # (n_src, W)
                if use_delta:
                    a_s = alpha_c(sx, sy)
                    w_src = (
                        screened_greens_norm_2d(r, sbar)
                        / jnp.sqrt(a_s * a_p)
                        * atten
                    )
                else:
                    w_src = greens_norm_2d(r)
                src_contrib = jnp.where(stepping & ~beyond, f_val * w_src, 0.0)
                walk_acc = walk_acc + src_contrib
            elif use_mis:
                # source-directed MIS: sample y from the balanced mixture
                # 0.5 * (ball-Green's density) + 0.5 * (source Gaussians);
                # the balance-heuristic weight G(x,y)/p_mix(y) is bounded
                # both far from the source (2*|G|) and at the source peaks
                # (2 G / q), unlike the plain estimator whose weight grows
                # like |G| * f_peak.
                gx = px + r_s * dx  # un-clamped Green's-side candidate
                gy = py + r_s * dy
                take_src = u[4] < 0.5
                mx, my = importance.sample(u[5], u[6], u[7])
                yx = jnp.where(take_src, mx, gx)
                yy = jnp.where(take_src, my, gy)
                d_y = jnp.sqrt((yx - px) ** 2 + (yy - py) ** 2)
                d_safe = jnp.maximum(d_y, 1e-12)
                if use_delta:
                    g_val = screened_greens_2d(d_safe, r, sbar)
                    norm = screened_greens_norm_2d(r, sbar)
                else:
                    g_val = greens_2d(d_safe, r)
                    norm = greens_norm_2d(r)
                g_val = jnp.maximum(g_val, 0.0)
                in_ball = d_y < r
                if has_neumann:
                    ydx = (yx - px) / d_safe
                    ydy = (yy - py) / d_safe
                    _, _, _, _, t_y, hit_y = queries.first_hit(
                        neumann, px, py, ydx, ydy, d_y, t_min_w
                    )
                    in_star = in_ball & ~(hit_y & (t_y < d_y))
                else:
                    in_star = in_ball
                # on-Neumann walkers sample directions from the inward
                # hemisphere, so the G-side area density is m*G/N with
                # m = 2 on the boundary — and by the image method the
                # correct on-boundary volume term is m * int G f as well
                m_ob = 1.0 + on_bdry.astype(jnp.float32)
                p_mix = 0.5 * jnp.where(in_ball, m_ob * g_val / norm, 0.0) \
                    + 0.5 * importance.pdf(yx, yy)
                w_mis = jnp.where(
                    in_star & (p_mix > 1e-30),
                    m_ob * g_val / jnp.maximum(p_mix, 1e-30),
                    0.0,
                )
                if use_delta:
                    a_y = alpha_c(yx, yy)
                    w_mis = w_mis / jnp.sqrt(a_y * a_p) * atten
                f_val = jnp.stack([f(yx, yy) for f in sources])
                src_contrib = jnp.where(stepping, f_val * w_mis, 0.0)
                walk_acc = walk_acc + src_contrib

            # -- move (WoStSolver.py:271-287) ----------------------------- #
            if use_delta:
                p_int = screened_interior_prob(r, sbar)
                interior = u[3] < p_int
                # An interior-sampled radius that reaches the Neumann hit
                # means the collision would have happened OUTSIDE the
                # domain: along that ray the event is really "survived to
                # the boundary" — a wall arrival that must carry the edge
                # weight sqrt(a_h/a_p) (NO null-collision factor) and the
                # on-boundary flag, exactly like an edge event. This is the
                # star-restricted Green's identity: the beyond-the-wall
                # interior mass IS the wall-arrival kernel. Two defects it
                # fixes vs the reference (whose walkers instead tunnel
                # through the surface and random-walk the unbounded
                # exterior — the notebook's "walk appears to be escaping"
                # TODO, cell 19): walker escape, and the spurious
                # (1 - sigma'/sigma_bar) reweighting of clamped moves,
                # which together biased 1000 m-scale potentials 2-4x low.
                collide = interior & ~(hit & (r_s >= t_hit - t_min))
                a_s_mv = alpha_c(sx, sy)
                a_h = alpha_c(hx, hy)
                sp_s = sigma_prime(sx, sy)
                # SIGNED null-collision factor (weighted delta tracking):
                # where sigma' exceeds the majorant, (1 - sigma'/sbar) < 0
                # is still the exact unbiased weight — the reference's
                # max(..., 0) clamp (WoStSolver.py:282) silently biased
                # the estimate toward the background solution wherever the
                # grid-scanned majorant under-resolved a thin sigma'
                # shell (measured -3-scale electrode bias on the notebook
                # survey before the refined scan + this fix; a violated
                # majorant now costs variance, never bias).
                scale_int = jnp.sqrt(a_s_mv / a_p) * (1.0 - sp_s / sbar)
                scale_edge = jnp.sqrt(a_h / a_p)
                atten_pre = atten  # chord-branch lanes skip the move scale
                if use_robin and not int_chord:
                    # Robin ARRIVAL weight (all modes except the opt-in
                    # interior-chord realization — see
                    # screened_greens_wall_ratio): gamma =
                    # d(ln sqrt alpha)/dn_out at the hit point; the kernel
                    # ratio is divided by the ray/normal cosine. The
                    # cos(phi) clamp tames the grazing-arrival 1/cos(phi)
                    # tail but DROPS a little real Robin mass — the
                    # dominant component (walks STARTING a fraction of a
                    # mfp from the wall: measured -8..-16 units on a
                    # 100-scale MMS, the notebook's -12 common-mode
                    # electrode offset) is removed exactly by on-boundary
                    # starts; the residual shrinks with
                    # robin_arrival_clamp (THEORY.md §4g).
                    glx = grad_log_alpha_x(hx, hy)
                    gly = grad_log_alpha_y(hx, hy)
                    gamma = -0.5 * (hnx * glx + hny * gly)
                    cosphi = jnp.maximum(
                        -(dx * hnx + dy * hny),
                        jnp.float32(self.options.robin_arrival_clamp))
                    rho = screened_greens_wall_ratio(t_hit, r, sbar)
                    # SIGNED arrival weight: 1 + gamma rho / cosphi can go
                    # negative for strongly absorbing walls (large -gamma,
                    # grazing arrival) and that negative value IS the
                    # unbiased kernel ratio — clamping it at 0 (as before
                    # the round-3 signed-weight pass) biased those
                    # arrivals' contributions high
                    w_rob = jnp.where(
                        hit, 1.0 + gamma * rho / cosphi, 1.0,
                    )
                    scale_edge = scale_edge * w_rob
                atten = jnp.where(
                    stepping,
                    atten * jnp.where(collide, scale_int, scale_edge),
                    atten,
                )
                newx = jnp.where(collide, sx, hx)
                newy = jnp.where(collide, sy, hy)
                a_next = jnp.where(collide, a_s_mv, a_h)  # alpha cache feed
                new_on_bdry = hit & ~collide
                if robin_chain:
                    # On-boundary CHORD continuation: for a walker standing
                    # ON the wall the Robin term int_flat gamma G_refl u~
                    # (G_refl = 2 G_s on the wall) is realized by branching
                    # with probability q_c to a chord point z = x + zeta t^,
                    # importance weight 2 gamma G_s(|zeta|)/p(zeta)/q_c;
                    # the non-branch continuation upweights by 1/(1 - q_c).
                    # q_c = min(1/2, |c|) with c = 4 gamma J(r) the ACTUAL
                    # chord mass (computed with the star radius above), so
                    # the branch weight is the O(1) density ratio
                    # G_s/(2 J p_mix): branches are rare (prob ~ |c|) and
                    # carry ~unit weight — no exp-compounding spread. (The
                    # earlier q = |gamma|/sqrt(sigma_bar) mis-scaled the
                    # branch rate and cost ~14x stderr on the notebook
                    # survey.) zeta is sampled from the BALANCED MIXTURE of
                    # a log sampler (|zeta| = r U1 U2, density
                    # -ln(|z|/r)/(2r), matching G_s's K0 log-divergence at
                    # 0) and a two-sided truncated exponential at rate
                    # sqrt(sigma_bar) (matching K0's decay tail), so the
                    # kernel ratio G_s/p_mix is bounded at BOTH ends.
                    # (Wall ARRIVALS of interior walkers carry their gamma
                    # term via w_rob above; on-boundary walkers have no
                    # self-wall arrivals, so this branch is the only
                    # realization of their flat term.)
                    q_scr = jnp.sqrt(jnp.maximum(sbar, 1e-12))
                    if int_chord:
                        # unified rate: on-boundary chord mass OR the
                        # decay-matched interior rate (THEORY.md §4g)
                        q_c = jnp.where(
                            on_bdry, jnp.minimum(0.5, c_mag), c_int)
                        l_eff = jnp.maximum(
                            jnp.where(on_bdry, r, l_ch), 1e-12)
                    else:
                        q_c = jnp.where(
                            on_bdry, jnp.minimum(0.5, c_mag), 0.0)
                        l_eff = r
                    fire = stepping & (u[8] < q_c) & (q_c > 1e-6)
                    side = jnp.where(u[9] < 0.5, -1.0, 1.0)
                    v = jnp.abs(2.0 * u[9] - 1.0)      # U1
                    tech_log = u[10] < 0.5             # technique selector
                    u2 = jnp.abs(2.0 * u[10] - 1.0)    # U2 (independent bit)
                    z_log = l_eff * jnp.maximum(v * u2, 1e-12)
                    trunc = 1.0 - jnp.exp(-q_scr * l_eff)
                    z_exp = -jnp.log(
                        jnp.maximum(1.0 - v * trunc, 1e-12)) / q_scr
                    az = jnp.minimum(
                        jnp.where(tech_log, z_log, z_exp), l_eff)
                    zeta = side * az
                    p_log = -jnp.log(
                        jnp.maximum(az / l_eff, 1e-12)) / (2.0 * l_eff)
                    p_exp = q_scr * jnp.exp(-q_scr * az) / (
                        2.0 * jnp.maximum(trunc, 1e-12))
                    p_mix = 0.5 * (p_log + p_exp)
                    if int_chord:
                        # interior chords evaluate the ball kernel at the
                        # true distance sqrt(zeta^2 + d_wall^2) <= r (the
                        # chord half-length caps |zeta| at sqrt(r^2-d^2));
                        # on-boundary lanes have d_wall = 0
                        dist_z = jnp.sqrt(az * az + d_wall * d_wall)
                    else:
                        dist_z = az
                    g_ch = jnp.maximum(
                        screened_greens_2d(dist_z, r, sbar), 0.0)
                    # chord point along the wall tangent THROUGH THE FOOT
                    # (== the walker itself for on-boundary lanes); the
                    # tangent is the exact segment direction, so z stays
                    # on the wall line to full f32 precision
                    zx = fx + zeta * t_cx
                    zy = fy + zeta * t_cy
                    # the identity's integrand is gamma(z) m G_s u~(z)
                    # (m = 2 on-boundary by the image fold, m = 1 for an
                    # interior ball): the branch weight must carry gamma
                    # AT THE SAMPLED CHORD POINT, not frozen at the
                    # walker — freezing gamma(x) biased the notebook
                    # survey (where gamma varies on the ~100 m anomaly
                    # scale under chords of comparable length) by a
                    # ~-10-unit common-mode electrode shift (32x30k-walk
                    # seeds vs the FDM oracle). The wall normal is
                    # constant along the flat chord, so the foot normal
                    # is the right normal at z.
                    glxz = grad_log_alpha_x(zx, zy)
                    glyz = grad_log_alpha_y(zx, zy)
                    gamma_z = -0.5 * (n_cx * glxz + n_cy * glyz)
                    m_img = 1.0 + on_bdry.astype(jnp.float32)
                    # the branch is a MOVE x -> z of the u-space walker:
                    # like scale_int/scale_edge it must carry the
                    # transform factor sqrt(alpha_z / alpha_x) (the chord
                    # identity lives in u~ = sqrt(alpha) u space). Omitting
                    # it biased every problem whose alpha differs between
                    # the walker and the wall point (-2% proportional on
                    # the layered MMS; part of the notebook offset).
                    a_z = alpha_c(zx, zy)
                    w_ch = (m_img * gamma_z * g_ch
                            / jnp.maximum(p_mix, 1e-30)
                            * jnp.sqrt(a_z / a_p))
                    # the integrand's support ends with the wall
                    # segment: chord samples past its ends carry zero
                    # weight (the branch still happens — redirecting
                    # it into the no-branch path would double-count
                    # the continuation; the zero-weight walk banks
                    # its already-accumulated walk_acc and roulette
                    # retires it)
                    w_ch = jnp.where(
                        (zeta >= s_lo) & (zeta <= s_hi), w_ch, 0.0)
                    branch = fire
                    # every lane with a live chord (on-boundary OR an
                    # interior ball overlapping the wall) pays the
                    # non-branch upweight 1/(1 - q)
                    chain_visit = q_c > 0.0
                    new_on_bdry = new_on_bdry | branch
                    newx = jnp.where(branch, zx, newx)
                    newy = jnp.where(branch, zy, newy)
                    a_next = jnp.where(branch, a_z, a_next)
                    atten = jnp.where(
                        branch,
                        atten_pre * w_ch / jnp.maximum(q_c, 1e-6),
                        atten * jnp.where(
                            stepping & chain_visit & (q_c > 1e-6),
                            1.0 / (1.0 - q_c), 1.0))
                # cap AFTER the chord rewrite (matching the Pallas kernel)
                # so it actually bounds the signed chord weights; symmetric
                # clip because chord weights can be negative
                if opts.max_attenuation is not None:
                    cap = jnp.float32(opts.max_attenuation)
                    atten = jnp.clip(atten, -cap, cap)
            else:
                newx, newy = hx, hy
                new_on_bdry = hit

            px = jnp.where(stepping, newx, px)
            py = jnp.where(stepping, newy, py)
            on_bdry = jnp.where(stepping, new_on_bdry, on_bdry)
            upd_n = stepping & hit
            if robin_chain:
                upd_n = upd_n & ~branch  # chord stays on its own wall
            nxx = jnp.where(upd_n, hnx, cnx)
            nyy = jnp.where(upd_n, hny, cny)
            if robin_chain:
                # an INTERIOR chord branch lands on the nearest wall: its
                # normal is the foot normal (a no-op for on-boundary
                # branches, whose foot normal IS the state normal)
                nxx = jnp.where(branch, n_cx, nxx)
                nyy = jnp.where(branch, n_cy, nyy)
            steps_cur = steps_cur + stepping.astype(jnp.int32)

            if use_delta and opts.roulette_threshold is not None:
                # low-weight Russian roulette (unbiased): survivors are
                # upweighted to the threshold, losers end their walk on
                # the next iteration with zero boundary weight
                thr = jnp.float32(opts.roulette_threshold)
                if rng_fast:
                    u_r = counter_uniform_lanes(
                        seed32 ^ jnp.uint32(0x0F1E2D3C), ctr, 1, lane_ids
                    )[0]
                else:
                    u_r = jax.random.uniform(
                        jax.random.fold_in(step_key, 2), (W,))
                low = stepping & (jnp.abs(atten) < thr)
                survive = u_r * thr < jnp.abs(atten)
                atten = jnp.where(
                    low,
                    jnp.where(survive,
                              jnp.where(atten < 0, -thr, thr), 0.0),
                    atten,
                )
                steps_cur = jnp.where(low & ~survive, max_steps, steps_cur)

            if use_delta and state.a_cur is not None:
                # moved lanes carry their move's alpha; recycled lanes the
                # start alpha; parked lanes keep what they had
                new_a_cur = jnp.where(
                    stepping, a_next,
                    jnp.where(walk_done, a_p0, state.a_cur))
            else:
                new_a_cur = state.a_cur
            # supercritical-weight tripwire: one cross-lane max per step
            # (cheap next to the segment scans); read by solve()'s guard
            new_wmax = jnp.maximum(
                state.wmax,
                jnp.max(jnp.where(stepping, jnp.abs(atten), 0.0)))
            new_state = WalkerState(
                a_cur=new_a_cur,
                wmax=new_wmax,
                bmax=new_bmax,
                px=px,
                py=py,
                on_bdry=on_bdry,
                nx=nxx,
                ny=nyy,
                atten=atten,
                walk_acc=walk_acc,
                quota=quota,
                steps_cur=steps_cur,
                acc_sum=acc_sum,
                acc_sumsq=acc_sumsq,
                n_done=n_done,
                total_steps=state.total_steps + jnp.sum(stepping.astype(jnp.float32)),
                step_idx=state.step_idx + 1,
                trunc_n=trunc_n,
                trunc_absw=trunc_absw,
            )
            # diagnostics are computed at the PRE-recycle positions so a
            # walk's terminal record pairs its recorded position with its
            # own geometry (the in-step d_sil/r above are evaluated after
            # finished lanes were reset to p0); production solves never
            # read diag, so XLA dead-code-eliminates the extra queries
            if has_neumann:
                d_sil_diag = queries.silhouette_distance(
                    neumann, state.px, state.py)
            else:
                d_sil_diag = jnp.full_like(dD, jnp.inf)
            diag = {
                "d_dirichlet": dD,
                "d_silhouette": d_sil_diag,
                "stepping": stepping,
                "walk_done": walk_done,
                # the boundary term bc * atten is source-INDEPENDENT (walk
                # paths don't depend on f), so every row of
                # contrib - walk_acc is identical; [0] is a squeeze, not a
                # restriction
                "boundary_contrib": jnp.where(
                    walk_done, (contrib - state.walk_acc)[0], 0.0
                ),
                "source_contrib": src_contrib,  # (n_src, W): full per-
                # source NEE record (multi-source ensembles trace every
                # current dipole, not just field 0)
                # plain star radius (before any Robin/majorant shrink)
                "radius": jnp.maximum(rmin, jnp.minimum(dD, d_sil_diag)),
                # per-step event masks (one-step consistency audits —
                # THEORY.md §4g methodology; dead-code-eliminated in
                # production solves like the rest of diag)
                "evt_collide": (collide & stepping) if use_delta
                else jnp.zeros_like(stepping),
                "evt_hit": (hit & stepping) if has_neumann
                else jnp.zeros_like(stepping),
                "evt_branch": (branch & stepping) if robin_chain
                else jnp.zeros_like(stepping),
            }
            return new_state, diag

        step.lane_ids = _lane_ids  # stream layout, for split-path seeding
        return step

    # ------------------------------------------------------------------ #
    # solve                                                              #
    # ------------------------------------------------------------------ #

    def _slot_layout(self, n_points: int, n_walks: int):
        """Distribute ``n_walks`` per point over K recycled slots.

        K is capped so each slot runs at least ``min_quota`` walks: the loop
        runs until the *slowest* walk finishes, so quota-1 slots spend the
        whole straggler tail idle, while recycling slots stay ~fully busy
        until their quota drains.
        """
        k_cap = max(1, n_walks // max(self.options.min_quota, 1))
        K = int(np.clip(self.options.target_slots // max(n_points, 1), 1, k_cap))
        from .split import reserve_quota_row

        frac = (self.options.split_reserve
                if self.options.split_threshold is not None else 0.0)
        return K, reserve_quota_row(n_walks, K, frac)

    def _use_pallas(self) -> bool:
        mode = self.options.backend
        if mode == "xla":
            return False
        from ..ops.pallas_walk import interpreting, pallas_supported

        ok = pallas_supported(self.problem)
        # features the kernel does not implement: falling back to them
        # SILENTLY would break the draw-for-draw backend invariant
        # (CLAUDE.md) for an option the user explicitly chose
        blockers = []
        if self.options.rng != "fast":
            blockers.append(f"rng='{self.options.rng}' (the kernel "
                            "implements the counter-hash RNG only)")
        if mode == "pallas":
            if not ok:
                raise ValueError(
                    "backend='pallas' supports boundaries of up to "
                    "ops/pallas_walk.MAX_TABLE_SEGMENTS segments"
                )
            if blockers:
                raise ValueError(
                    "backend='pallas' does not support: "
                    + "; ".join(blockers)
                    + ". Use backend='xla' or drop the option."
                )
            if not (self._on_gpu() or interpreting()):
                raise ValueError(
                    "backend='pallas' compiles for the GPU only; on "
                    f"{self._platform()!r} run it inside "
                    "ops.pallas_walk.interpret_mode() or use backend='xla'"
                )
            return True
        return ok and not blockers and self._on_gpu()

    def _platform(self) -> str:
        return jax.default_backend()

    def _on_gpu(self) -> bool:
        return self._platform() == "gpu"

    def _build_solve_fn(self, n_points: int, n_walks: int, max_steps: int, eps: float):
        # keyed on the problem version so Problem setters (set_source_term,
        # set_boundary_conditions) invalidate the compiled physics. The
        # cache is PER-INSTANCE (a plain dict, not lru_cache on the method:
        # that would share hit/miss stats across every solver and pin each
        # solver — and its traced problem closures — alive for the process
        # lifetime).
        key = (n_points, n_walks, max_steps, eps, self.problem.version,
               self._progress_cb is not None)
        fn = self._solve_cache.pop(key, None)
        if fn is None:
            fn = self._build_solve_fn_uncached(n_points, n_walks, max_steps, eps)
            if len(self._solve_cache) >= 32:  # LRU bound (insertion order)
                self._solve_cache.pop(next(iter(self._solve_cache)))
        self._solve_cache[key] = fn
        return fn

    def _build_solve_fn_uncached(
        self, n_points: int, n_walks: int, max_steps: int, eps: float
    ):
        if self._use_pallas():
            return self._build_solve_fn_pallas(n_points, n_walks, max_steps, eps)
        return self._build_solve_fn_xla(n_points, n_walks, max_steps, eps)

    def _boundary_snap_tol(self, eps):
        """Resolve ``SolverOptions.boundary_snap`` to a distance or None.

        ``"auto"`` = ``eps / 2`` — the walk's own resolution scale: a point
        within the Dirichlet termination shell is "on the boundary" by the
        method's definition, so the same tolerance is the principled
        "meant to be ON the wall" radius for Neumann starts. (A
        diameter-proportional auto was too aggressive: on the 1000 m
        notebook it was 1.4 m and silently moved electrodes deliberately
        placed 1.1 m inside the domain.)
        """
        bs = self.options.boundary_snap
        if self.problem.neumann is None or bs in (None, 0, 0.0, False):
            return None
        if bs == "auto":
            return 0.5 * float(eps)
        return float(bs)

    def _snap_points(self, points, tol):
        """Snap near-wall evaluation points ONTO the Neumann wall.

        Returns ``(px, py, ob0, n0x, n0y)``: snapped coordinates, the
        on-boundary start mask, and inward start normals. Points exactly
        ON the wall (d == 0) are left alone — their inward side cannot be
        inferred; give surface points a tiny inward nudge (the survey
        pipelines do) and the solver starts them with the EXACT
        on-boundary half-ball machinery instead of the legacy interior
        first step, whose grazing wall arrivals carried the
        robin_arrival_clamp's Robin-mass loss (THEORY.md §4g).
        """
        # the tolerance is resolved eagerly at build time and passed in:
        # callers sit inside traced code (jit / shard_map)
        ptx, pty = points[:, 0], points[:, 1]
        if tol is None:
            return ptx, pty, None, None, None
        d0, f0x, f0y, t0x, t0y, _, _ = queries.closest_point_chord(
            self.problem.neumann, ptx, pty)
        m0 = (d0 <= tol) & (d0 > 0.0)
        dotn = (ptx - f0x) * (-t0y) + (pty - f0y) * t0x
        sg = jnp.where(dotn >= 0.0, 1.0, -1.0)
        return (
            jnp.where(m0, f0x, ptx),
            jnp.where(m0, f0y, pty),
            m0,
            jnp.where(m0, sg * (-t0y), 0.0),
            jnp.where(m0, sg * t0x, 0.0),
        )

    def _wrap_step_progress(self, step, total_walks: int, every: int = 64):
        """Wrap a step fn to report progress from inside the compiled loop.

        Every ``every`` iterations a ``jax.debug.callback`` ships
        ``(walks done, iteration)`` to the host trampoline, which calls
        the CURRENT ``self._progress_cb`` — the reference's per-point tqdm
        (``WoStSolver.py:182``) reimagined for a solver whose whole solve
        is one device loop. Walks-done is total quota minus remaining
        quota (approximate while split clones hold temporary quota).
        """
        def _report(done, it):
            cb = self._progress_cb
            if cb is not None:
                cb(int(done), total_walks, int(it))

        def wrapped(s, p0x, p0y, key, sid=None, **kw):
            s2, d = step(s, p0x, p0y, key, sid=sid, **kw)
            jax.lax.cond(
                s2.step_idx % every == 0,
                lambda done, it: jax.debug.callback(_report, done, it),
                lambda done, it: None,
                jnp.maximum(total_walks - jnp.sum(s2.quota), 0),
                s2.step_idx,
            )
            return s2, d

        wrapped.lane_ids = step.lane_ids
        return wrapped

    def _build_solve_fn_xla(self, n_points: int, n_walks: int, max_steps: int, eps: float):
        K, quota_row = self._slot_layout(n_points, n_walks)
        snap_tol = self._boundary_snap_tol(eps)
        crn = ("tile", K, n_points) if self.options.common_random_numbers else None
        quotas = jnp.asarray(np.tile(quota_row, n_points))
        max_quota = int(quota_row.max())
        step_cap = max_quota * (max_steps + 1) + 2
        step = self._make_step_core(eps, max_steps, crn=crn)
        if self._progress_cb is not None:
            step = self._wrap_step_progress(step, n_points * n_walks)

        n_src = max(1, len(self.problem.source_fields))
        use_split = (
            self.options.split_threshold is not None
            and self.problem.use_delta_tracking
            and self.options.rng == "fast"  # clones need fresh hash streams
        )
        if self.options.split_threshold is not None and not use_split:
            import warnings

            warnings.warn(
                "split_threshold is inert here: splitting applies to "
                "delta-tracking problems with rng='fast' (weights stay "
                "at 1.0 otherwise, so no lane can exceed the threshold).",
                stacklevel=3,
            )

        def _finish(final, finished):
            sums = final.acc_sum.reshape(n_src, n_points, K).sum(axis=2)
            sumsq = final.acc_sumsq.reshape(n_src, n_points, K).sum(axis=2)
            mean = sums / n_walks
            var = jnp.maximum(sumsq / n_walks - mean * mean, 0.0)
            stderr = jnp.sqrt(var / n_walks)
            return RawSolveOut(
                mean=mean, stderr=stderr, walk_sum=sums, walk_sumsq=sumsq,
                total_steps=final.total_steps, iterations=final.step_idx,
                truncated_walks=final.trunc_n,
                truncated_weight=final.trunc_absw,
                max_weight=final.wmax,
                max_banked=final.bmax,
                finished_walks=finished,
            )

        # cross-step alpha cache: carry alpha(walker) in state so the hot
        # loop never re-evaluates the field at the walker's own position
        # (the move already evaluated it at every candidate destination).
        # Kept for draw-for-draw parity with the kernel carry and for
        # expensive alpha fields.
        use_cache = self.problem.use_delta_tracking
        alpha0_v = jax.vmap(_lift(self.problem.alpha_c)) if use_cache \
            else None

        if not use_split:
            def run(points, key):
                ptx, pty, ob0, n0x, n0y = self._snap_points(points, snap_tol)
                p0x = jnp.repeat(ptx, K)
                p0y = jnp.repeat(pty, K)
                a0 = alpha0_v(p0x, p0y) if use_cache else None
                state = init_state(p0x, p0y, quotas, n_src=n_src, a0=a0)
                if ob0 is None:
                    p0ob = p0nx = p0ny = None
                else:
                    p0ob = jnp.repeat(ob0, K)
                    p0nx = jnp.repeat(n0x, K)
                    p0ny = jnp.repeat(n0y, K)
                    state = state._replace(on_bdry=p0ob, nx=p0nx, ny=p0ny)

                def cond(s):
                    return (s.step_idx < step_cap) & jnp.any(s.quota > 0)

                def body(s):
                    s2, _ = step(s, p0x, p0y, key,
                                 p0ob=p0ob, p0nx=p0nx, p0ny=p0ny, p0a=a0)
                    return s2

                final = jax.lax.while_loop(cond, body, state)
                return _finish(
                    final, jnp.sum(final.n_done).astype(jnp.float32))

            return jax.jit(run)

        # ---- sweep loop: in-graph high-weight splitting (THEORY.md §5) -- #
        # One shared pairing/halving/stream-allocation implementation
        # serves this point-major layout AND the sharded slot-major one
        # (see solver/split.py). Unlike the Pallas host loop (split at
        # launch boundaries), this bounds weight compounding at
        # SPLIT_EVERY steps.
        from .split import make_ingraph_split, run_split_while

        do_split = make_ingraph_split(
            self.options.split_threshold, n_points, K, slot_major=False
        )
        # the step core's own stream layout (exposed as step.lane_ids) is
        # the single source of truth — re-deriving it here would silently
        # diverge if the crn tuple's mode ever changes
        sid0 = step.lane_ids(n_points * K)

        def run(points, key):
            ptx, pty, ob0, n0x, n0y = self._snap_points(points, snap_tol)
            p0x = jnp.repeat(ptx, K)
            p0y = jnp.repeat(pty, K)
            a0 = alpha0_v(p0x, p0y) if use_cache else None
            state = init_state(p0x, p0y, quotas, n_src=n_src, a0=a0)
            if ob0 is None:
                def step_s(s, a, b, k, sid=None):
                    return step(s, a, b, k, sid=sid, p0a=a0)
            else:
                p0ob = jnp.repeat(ob0, K)
                p0nx = jnp.repeat(n0x, K)
                p0ny = jnp.repeat(n0y, K)
                state = state._replace(on_bdry=p0ob, nx=p0nx, ny=p0ny)

                def step_s(s, a, b, k, sid=None):
                    return step(s, a, b, k, sid=sid,
                                p0ob=p0ob, p0nx=p0nx, p0ny=p0ny, p0a=a0)
            # clone streams start at 2^30, above all lane/CRN ids
            final = run_split_while(
                step_s, do_split, state, p0x, p0y, key,
                sid0, jnp.uint32(1 << 30), step_cap, max_steps,
            )
            return _finish(final, jnp.float32(jnp.nan))

        return jax.jit(run)

    def _build_solve_fn_pallas(
        self, n_points: int, n_walks: int, max_steps: int, eps: float
    ):
        """Fused-kernel solve: launch loop around the multi-step Pallas
        kernel (``ops/pallas_walk.py``), which advances every walker up to
        ``pallas_inner_steps`` per launch with its state in registers.

        When nothing needs launch boundaries (no split, packing or
        progress) the solve is ONE adaptive kernel launch inside a jitted
        function. ``compaction="pack"`` keeps a jitted launch loop that
        periodically PERMUTES still-active walker lanes into the leading
        kernel blocks (stream ids ride in the state, so a lane's walk is
        unchanged by where it lives) so drained trailing blocks take the
        kernel's per-block early exit. Splitting and progress run the
        launch loop on the host.
        """
        from ..ops.pallas_walk import make_pallas_walk, stream_ids

        opts = self.options
        pb = self.problem
        K, quota_row = self._slot_layout(n_points, n_walks)
        block_rows = opts.pallas_block_rows
        lane_block = block_rows * 128
        W = n_points * K
        rows = max(block_rows,
                   ((W + lane_block - 1) // lane_block) * block_rows)
        W_pad = rows * 128
        n_inner = opts.pallas_inner_steps
        # same point-major CRN stream layout as the XLA path
        crn = ("tile", K, n_points) if opts.common_random_numbers else None
        snap_tol = self._boundary_snap_tol(eps)
        use_snap = snap_tol is not None
        use_split = (opts.split_threshold is not None
                     and pb.use_delta_tracking)
        plan = make_pallas_walk(
            pb,
            eps=eps,
            max_steps=max_steps,
            t_min=opts.t_min_frac * pb.diameter,
            rmin=opts.rmin_factor * eps,
            project=opts.project_to_boundary,
            n_inner=n_inner,
            block_rows=block_rows,
            rejection_rounds=opts.rejection_rounds,
            screened_sampler=opts.screened_sampler,
            max_attenuation=opts.max_attenuation,
            robin_correction=self._robin_enabled(),
            roulette_threshold=opts.roulette_threshold,
            robin_arrival_clamp=opts.robin_arrival_clamp,
            snap_starts=use_snap,
            freeze_split=use_split,
        )
        max_quota = int(quota_row.max())
        launch_cap = (max_quota * (max_steps + 1) + 2) // n_inner + 2
        n_src = max(1, len(pb.source_fields))
        if opts.split_threshold is not None and not use_split:
            import warnings

            warnings.warn(
                "split_threshold is inert here: splitting applies to "
                "delta-tracking problems (weights stay at 1.0 otherwise "
                "— and cloning unit-weight walks would double-count their "
                "source contributions).",
                stacklevel=3,
            )

        # slot layout: point-major (point i owns slots i*K..(i+1)*K-1), padded
        quotas = np.zeros((W_pad,), np.int32)
        quotas[:W] = np.tile(quota_row, n_points)
        point_id = np.zeros((W_pad,), np.int32)
        point_id[:W] = np.repeat(np.arange(n_points, dtype=np.int32), K)
        point_id[W:] = 0  # padded slots have quota 0: contribute nothing
        quotas_j = jnp.asarray(quotas).reshape(rows, 128)
        point_id_j = jnp.asarray(point_id)
        sid0 = stream_ids(rows, crn)

        def init_state(points, key):
            if use_snap:
                ptx, pty, ob0, n0x, n0y = self._snap_points(
                    points, tol=snap_tol)
            else:
                ptx, pty = points[:, 0], points[:, 1]
            p0x = jnp.concatenate(
                [jnp.repeat(ptx, K),
                 jnp.zeros((W_pad - W,), jnp.float32)]
            ).reshape(rows, 128)
            p0y = jnp.concatenate(
                [jnp.repeat(pty, K),
                 jnp.zeros((W_pad - W,), jnp.float32)]
            ).reshape(rows, 128)
            f0 = jnp.zeros((rows, 128), jnp.float32)
            i0_ = jnp.zeros((rows, 128), jnp.int32)
            state = {
                "p0x": p0x, "p0y": p0y, "sid": sid0,
                "px": p0x, "py": p0y,
                "nx": f0, "ny": f0,
                "atten": f0 + 1.0,
                "quota": quotas_j, "steps": i0_, "ndone": i0_, "ob": i0_,
                "life": i0_,
                "tn": f0, "tw": f0, "wmax": f0, "bmax": f0,
            }
            if use_snap:
                pad1 = lambda a, dt: jnp.concatenate(
                    [jnp.repeat(a.astype(dt), K),
                     jnp.zeros((W_pad - W,), dt)]).reshape(rows, 128)
                state["ob0"] = pad1(ob0, jnp.int32)
                state["n0x"] = pad1(n0x, jnp.float32)
                state["n0y"] = pad1(n0y, jnp.float32)
                state["ob"] = state["ob0"]
                state["nx"] = state["n0x"]
                state["ny"] = state["n0y"]
            for i in range(n_src):
                state[f"acc{i}"] = f0
                state[f"asum{i}"] = f0
                state[f"asq{i}"] = f0
            # the stream seed is derived exactly like the XLA fast path's
            # and stays FIXED across launches — per-lane (walk#, step#)
            # counters advance the randomness, making walks independent of
            # the launch partitioning and of lane permutations
            kd = jnp.asarray(key, jnp.uint32).reshape(-1)
            seed_i = jax.lax.bitcast_convert_type(
                kd[0] ^ mix32(kd[-1]), jnp.int32
            )
            return state, seed_i

        def _moments(state, pid):
            sums = jnp.stack([
                jax.ops.segment_sum(
                    state[f"asum{i}"].reshape(-1), pid,
                    num_segments=n_points,
                )
                for i in range(n_src)
            ])
            sumsq = jnp.stack([
                jax.ops.segment_sum(
                    state[f"asq{i}"].reshape(-1), pid,
                    num_segments=n_points,
                )
                for i in range(n_src)
            ])
            return (sums, sumsq, jnp.sum(state["life"].astype(jnp.float32)),
                    jnp.sum(state["tn"]), jnp.sum(state["tw"]),
                    jnp.max(state["wmax"]), jnp.max(state["bmax"]))

        want_progress = self._progress_cb is not None
        # "pack" = in-graph lane packing (end-to-end jittable; also on
        # the host loop below when split/progress need it)
        use_pack = opts.compaction == "pack"

        if not (opts.compaction or use_split or want_progress) or (
                use_pack and not (use_split or want_progress)):
            # adaptive single-launch mode: nothing on this path needs
            # launch boundaries, so hand the kernel the WHOLE remaining
            # step bound as its runtime budget — each block's early exit
            # ends it exactly when its quota drains, and the per-launch
            # dispatch + full-state round trip disappears. The while
            # loop below is kept as a pure safety net (it runs once).
            # Packing mode still wants boundaries to re-sort at.
            adaptive = opts.adaptive_launches and not use_pack
            step_bound = max_quota * (max_steps + 1) + 2
            ni_run = step_bound if adaptive else None
            eff_cap = 2 if adaptive else launch_cap

            def run(points, key):
                state, seed_i = init_state(points, key)

                def pack(st, pid):
                    # stable active-first permutation of every per-lane
                    # plane (stream ids / start points / snap normals /
                    # accumulators / point ids all ride along, so walks
                    # and statistics are unchanged — only which BLOCK a
                    # lane lives in moves, letting drained trailing
                    # blocks hit the kernel's early exit)
                    inactive = (st["quota"].reshape(-1) <= 0).astype(
                        jnp.int32)
                    perm = jnp.argsort(inactive, stable=True)
                    ns = {k: v.reshape(-1)[perm].reshape(v.shape)
                          for k, v in st.items()}
                    return ns, pid[perm]

                def cond(c):
                    launches = c[2]
                    return (launches < eff_cap) & jnp.any(
                        c[0]["quota"] > 0)

                def body(c):
                    st, pid, launches, last_pack = c
                    st = plan.run(st, seed_i, inner_steps=ni_run)
                    if use_pack:
                        # re-pack only when the active population halved
                        # since the last pack: amortizes the argsort +
                        # full-state gather to O(log) packs per solve,
                        # so saturated workloads pay ~nothing
                        active = jnp.sum(
                            (st["quota"] > 0).astype(jnp.int32))
                        st, pid, last_pack = jax.lax.cond(
                            2 * active < last_pack,
                            lambda s, p, _a: pack(s, p) + (active,),
                            lambda s, p, a: (s, p, a),
                            st, pid, last_pack,
                        )
                    return st, pid, launches + 1, last_pack

                state, pid, launches, _ = jax.lax.while_loop(
                    cond, body,
                    (state, point_id_j, jnp.int32(0), jnp.int32(W_pad)),
                )
                (sums, sumsq, total_steps,
                 trunc_n, trunc_w, wmax, bmax) = _moments(state, pid)
                mean = sums / n_walks
                var = jnp.maximum(sumsq / n_walks - mean * mean, 0.0)
                stderr = jnp.sqrt(var / n_walks)
                return RawSolveOut(
                    mean=mean, stderr=stderr, walk_sum=sums,
                    walk_sumsq=sumsq, total_steps=total_steps,
                    iterations=jnp.max(state["life"]),
                    truncated_walks=trunc_n, truncated_weight=trunc_w,
                    max_weight=wmax, max_banked=bmax,
                    finished_walks=jnp.sum(state["ndone"]).astype(
                        jnp.float32),
                )

            return jax.jit(run)

        # ---- host-driven launch loop: compaction/splitting/progress ---- #
        init_j = jax.jit(init_state)
        launch_j = jax.jit(plan.run)
        count_j = jax.jit(lambda st: (st["quota"] > 0).sum())
        qsum_j = jax.jit(lambda st: jnp.sum(st["quota"]))
        maxlife_j = jax.jit(lambda st: jnp.max(st["life"]))
        ndone_j = jax.jit(lambda st: jnp.sum(st["ndone"]))
        moments_j = jax.jit(_moments)
        total_walks = n_points * n_walks

        # ONE shared launch-boundary split implementation (solver/split.py)
        # serves this host loop and the sharded Pallas path; jit retraces
        # per state shape as compaction shrinks rows
        if use_split:
            from .split import make_launch_split

            split_j = jax.jit(make_launch_split(
                opts.split_threshold, n_src, n_points))
            thr_f = float(opts.split_threshold)
            heavy_j = jax.jit(lambda st: (
                (st["quota"] > 0)
                & (jnp.abs(st["atten"]) > thr_f)).sum())

        if use_pack:
            @jax.jit
            def pack_host(st, pid):
                inactive = (st["quota"].reshape(-1) <= 0).astype(jnp.int32)
                perm = jnp.argsort(inactive, stable=True)
                ns = {k: v.reshape(-1)[perm].reshape(v.shape)
                      for k, v in st.items()}
                return ns, pid[perm]

        def run(points, key):
            state, seed_i = init_j(points, key)
            pid = point_id_j
            carry_sum = jnp.zeros((n_src, n_points), jnp.float32)
            carry_sq = jnp.zeros((n_src, n_points), jnp.float32)
            launches = 0
            sid_base = 1 << 30  # clone stream ids live above all lane ids
            # splits stop at launch_cap; the loop then runs long enough
            # for every clone (remaining walk <= max_steps) to finish, so
            # no clone half-weight is truncated (the in-graph split's
            # exactness contract at launch granularity)
            split_reserve = (max_steps // n_inner + 1) if use_split else 0
            # in-launch freeze (ops/pallas_walk.py freeze_split): frozen
            # lanes defer their steps to later launches, so the drain
            # bound doubles — by launch_cap the freeze is forced open
            # (+inf), after which every lane's remaining work fits in one
            # more launch_cap span. Normal runs still break on active==0.
            hard_cap = ((2 * launch_cap if use_split else launch_cap)
                        + split_reserve)
            cur_thr = thr_f if use_split else None
            last_pack = W_pad
            while launches < hard_cap:
                if use_split:
                    state = launch_j(state, seed_i, np.float32(cur_thr))
                else:
                    state = launch_j(state, seed_i)
                launches += 1
                active = int(count_j(state))
                cb = self._progress_cb
                if cb is not None:
                    done = max(total_walks - int(qsum_j(state)), 0)
                    cb(done, total_walks, launches * n_inner)
                if active == 0:
                    break
                if use_split and launches < launch_cap:
                    state, pid, n_split, dsum, dsq = split_j(
                        state, pid, np.int32(sid_base))
                    sid_base += int(n_split)
                    carry_sum = carry_sum + dsum
                    carry_sq = carry_sq + dsq
                    active = int(count_j(state))
                    # fail OPEN when every remaining active lane is heavy
                    # (frozen) and idle-starved: the next launch runs
                    # unfrozen so the solve always makes progress; also
                    # forced open once splits stop at launch_cap
                    heavy = int(heavy_j(state))
                    cur_thr = (np.inf if 0 < heavy == active else thr_f)
                elif use_split:
                    cur_thr = np.inf
                if use_pack:
                    # in-graph-style lane packing on the host loop (same
                    # halving trigger as the jittable path)
                    if 2 * active < last_pack:
                        state, pid = pack_host(state, pid)
                        last_pack = active
            sums, sumsq, life, tn, tw, wmax, bmax = moments_j(state, pid)
            sums = np.asarray(sums) + np.asarray(carry_sum)
            sumsq = np.asarray(sumsq) + np.asarray(carry_sq)
            mean = sums / n_walks
            var = np.maximum(sumsq / n_walks - mean * mean, 0.0)
            stderr = np.sqrt(var / n_walks)
            return RawSolveOut(
                mean=mean, stderr=stderr, walk_sum=sums, walk_sumsq=sumsq,
                total_steps=float(life),
                iterations=int(maxlife_j(state)),
                truncated_walks=float(tn),
                truncated_weight=float(tw),
                max_weight=float(wmax),
                max_banked=float(bmax),
                finished_walks=(np.nan if use_split
                                else float(ndone_j(state))),
            )

        return run

    def solve(
        self,
        points,
        n_walks: int = 1000,
        max_steps: int = 1000,
        eps: float = 1e-4,
        seed: int = 0,
        return_history: bool = False,
        history_walks: int = 16,
        progress: Callable = None,
    ):
        """Estimate the PDE solution at ``points``.

        Mirror of reference ``solve`` (``solvers/WoStSolver.py:319-353``)
        with the same knobs; additionally returns the per-point empirical
        standard error (the reference returns only the mean).

        ``progress``: optional ``callback(done_walks, total_walks,
        iteration)`` — the reference's tqdm affordance
        (``WoStSolver.py:182``) for a compiled solver: fired from inside
        the device loop every ~64 steps (XLA backend, via
        ``jax.debug.callback``) or once per kernel launch (Pallas
        backend, whose launch loop runs on the host when progress is
        requested). Sharded solvers report too: device 0's shard
        progress scaled by the mesh size — exact at the endpoints,
        approximate in between (device loops stay collective-free).

        Args:
            points: ``(N, 2)`` evaluation points.
            n_walks: walks per point.
            max_steps: per-walk step cap.
            eps: Dirichlet termination shell width.
            seed: RNG seed (counter-based threefry; reproducible).
            return_history: also capture traced walks per point in the
                reference's history-dict schema (``WoStSolver.py:330-349``).
                Unlike the reference — which records *every* walk and is
                memory-unbounded — the capture is a separate bounded run of
                ``history_walks`` walks per point (see
                ``diagnostics/history.py``).

        Returns:
            :class:`SolveResult`, or ``(SolveResult, history_dict)`` when
            ``return_history`` is set.
        """
        pts = jnp.asarray(np.asarray(points, np.float32).reshape(-1, 2))
        n_points = int(pts.shape[0])
        self._progress_cb = progress
        fn = self._build_solve_fn(n_points, int(n_walks), int(max_steps), float(eps))
        key = jax.random.PRNGKey(seed)
        raw = fn(pts, key)
        mean = np.asarray(raw.mean)
        stderr = np.asarray(raw.stderr)
        sums = np.asarray(raw.walk_sum)
        sumsq = np.asarray(raw.walk_sumsq)
        # single-source problems keep the reference's flat (N,) shape;
        # multi-source problems return (n_src, N)
        if len(self.problem.source_fields) <= 1:
            mean = mean[0]
            stderr = stderr[0]
            sums = sums[0]
            sumsq = sumsq[0]
        result = SolveResult(
            mean=mean,
            stderr=stderr,
            n_walks=int(n_walks),
            total_steps=float(raw.total_steps),
            iterations=int(raw.iterations),
            truncated_walks=float(raw.truncated_walks),
            truncated_weight=float(raw.truncated_weight),
            max_weight=float(raw.max_weight),
            max_banked=float(raw.max_banked),
            walk_sum=sums,
            walk_sumsq=sumsq,
        )
        self._warn_supercritical(result.max_banked, sumsq, int(n_walks))
        if not return_history:
            return result
        from ..diagnostics.history import trace_walks

        history = {}
        for i in range(n_points):
            h = trace_walks(
                self,
                np.asarray(pts[i]),
                n_walks=history_walks,
                max_steps=int(max_steps),
                eps=float(eps),
                seed=seed + i,
            )
            history[i] = h.to_dict()[0]
        return result, history
