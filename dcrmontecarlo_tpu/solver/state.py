"""SoA walker state for the batched Walk-on-Stars loop.

Replacement for the reference's per-walk Python locals
(``solvers/WoStSolver.py:188-195``): every scalar the interpreted loop kept
per walk becomes a ``(W,)`` lane of a structure-of-arrays pytree carried
through ``lax.while_loop``. Walker *slots* are recycled: each slot owns a
quota of walks for one evaluation point and immediately starts its next
walk when one terminates, keeping VPU occupancy high despite the heavy
tail of the walk-length distribution (SURVEY.md §7 hard part 3).
"""

from typing import NamedTuple, Optional

import jax.numpy as jnp

__all__ = ["WalkerState", "init_state"]


class WalkerState(NamedTuple):
    """All arrays have shape ``(W,)`` unless noted.

    Accumulators (``walk_acc``, ``acc_sum``, ``acc_sumsq``) carry a leading
    source axis ``(n_src, W)``: walk *paths* are independent of the source
    term (they depend only on geometry and coefficients), so one walker
    ensemble estimates the solution for many source fields simultaneously —
    each source costs only one extra field evaluation per step, not a new
    ensemble. The single-source case is ``n_src = 1``.
    """

    px: jnp.ndarray          # f32 current walker position x
    py: jnp.ndarray          # f32 current walker position y
    on_bdry: jnp.ndarray     # bool standing on the Neumann boundary
    nx: jnp.ndarray          # f32 inward normal at the last Neumann hit
    ny: jnp.ndarray          # f32
    atten: jnp.ndarray       # f32 delta-tracking attenuation (1.0 otherwise)
    walk_acc: jnp.ndarray    # f32 (n_src, W) source contributions, this walk
    quota: jnp.ndarray       # i32 walks left for this slot (incl. current)
    steps_cur: jnp.ndarray   # i32 steps taken in the current walk
    acc_sum: jnp.ndarray     # f32 (n_src, W) sum of finished-walk totals
    acc_sumsq: jnp.ndarray   # f32 (n_src, W) sum of squared totals
    n_done: jnp.ndarray      # i32 finished walks
    total_steps: jnp.ndarray  # () f32 active walker-steps taken (diagnostic)
    step_idx: jnp.ndarray    # () i32 global loop iteration (RNG counter)
    trunc_n: jnp.ndarray     # () f32 walks ended by the max_steps cap with
                             #     nonzero weight (roulette kills excluded —
                             #     they end with atten == 0 by design)
    wmax: jnp.ndarray        # () f32 running max |atten| over stepping
                             #     lanes — surfaced as
                             #     SolveResult.max_weight (diagnostic
                             #     only since round 5: transient weight
                             #     excursions that decay before banking
                             #     are harmless, so the guard reads bmax)
    bmax: jnp.ndarray        # () f32 running max |banked walk total|
                             #     (max over sources). solve()'s
                             #     supercritical guard warns when
                             #     bmax^2 exceeds half a point's walk
                             #     sum-of-squares: then ONE walk carries
                             #     most of that point's variance mass and
                             #     the reported stderr is meaningless.
    trunc_absw: jnp.ndarray  # () f32 sum of |atten| those walks carried:
                             #     the magnitude of the estimate mass the
                             #     cap silently dropped. The truncation
                             #     bias is -E[atten*(u - bc)(x_T)], so a
                             #     large value relative to n_walks flags a
                             #     max_steps too small for the problem
                             #     (failure detection, SURVEY §2 A3).
    a_cur: Optional[jnp.ndarray] = None   # f32 cached alpha at the CURRENT
                                          # position (delta tracking only).
                                          # Every move's destination alpha
                                          # is already evaluated in-step
                                          # (a_s / a_h / a_z), so carrying
                                          # it saves the walker-position
                                          # re-eval next step — the single
                                          # avoidable field eval of the
                                          # hot loop. None = recompute
                                          # each step (pre-cache behavior)


def init_state(p0x, p0y, quotas, n_src: int = 1, a0=None) -> WalkerState:
    """``a0``: per-lane alpha at the start positions — enables the
    cross-step alpha cache (``WalkerState.a_cur``); ``None`` keeps the
    recompute-every-step behavior."""
    w = p0x.shape[0]
    f0 = jnp.zeros((w,), jnp.float32)
    acc0 = jnp.zeros((n_src, w), jnp.float32)
    return WalkerState(
        a_cur=None if a0 is None else jnp.asarray(a0, jnp.float32),
        px=p0x.astype(jnp.float32),
        py=p0y.astype(jnp.float32),
        on_bdry=jnp.zeros((w,), bool),
        nx=f0,
        ny=f0,
        atten=jnp.ones((w,), jnp.float32),
        walk_acc=acc0,
        quota=quotas.astype(jnp.int32),
        steps_cur=jnp.zeros((w,), jnp.int32),
        acc_sum=acc0,
        acc_sumsq=acc0,
        n_done=jnp.zeros((w,), jnp.int32),
        total_steps=jnp.zeros((), jnp.float32),
        step_idx=jnp.zeros((), jnp.int32),
        trunc_n=jnp.zeros((), jnp.float32),
        trunc_absw=jnp.zeros((), jnp.float32),
        wmax=jnp.zeros((), jnp.float32),
        bmax=jnp.zeros((), jnp.float32),
    )
