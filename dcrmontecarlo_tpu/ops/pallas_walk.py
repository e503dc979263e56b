"""Fused Pallas walk kernel (Triton route) for the WoSt solver.

The XLA ``lax.while_loop`` solver advances the walker state one step per
loop trip: every trip reads and writes the whole structure-of-arrays
walker state through device memory, split over several fusions, and
evaluates the loop predicate ``any(quota > 0)`` to decide the next trip.
This kernel instead:

* keeps each walker's state in registers for up to ``n_inner`` walk steps
  per launch (the adaptive single launch runs a block until its quota
  drains), so device memory sees the state once per launch;
* tiles walkers over independent grid blocks of ``(block_rows, 128)``
  lanes — no value carries between blocks, so they run in any order on
  any SM — and ends each block as soon as its own quota drains;
* draws randomness from the SAME per-lane counter hash as the XLA step
  (``sampling/rng.py``): uniforms depend only on ``(stream id, walk#,
  step#, seed)``, so kernel walks are reproducible across launch
  partitionings, common random numbers work (stream id = slot id), and
  interpret-mode runs are deterministic and host-checkable against the
  XLA backend;
* **unrolls the polyline geometry statically**: segment endpoints and
  interior-vertex triples are baked into the kernel as scalar constants
  (the boundary is static problem data), so the per-step closest-point /
  silhouette / first-hit queries are pure register arithmetic. Larger
  boundaries loop over segment tables in device memory read by scalar
  index;
* runs the same branchless step semantics as
  ``solver/wost.py::_make_step_core`` (termination + recycle, star radius,
  hemisphere direction, first hit, source NEE, delta-tracking move), and
  the same two-regime **exact screened-radius rejection sampler** as
  ``sampling/radial.py::sample_screened_radius_exact`` through the shared
  ``jnp`` samplers, which lower into the kernel unchanged.

The kernel is lowered through Pallas's Triton route
(``backend="triton"``). On a machine without a GPU it runs only inside
:func:`interpret_mode`, Pallas's interpreter — that is how the tests
exercise it on the CPU.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

__all__ = ["make_pallas_walk", "pallas_supported", "stream_ids",
           "interpret_mode", "interpreting", "num_warps",
           "MAX_UNROLL_SEGMENTS"]

MAX_UNROLL_SEGMENTS = 96   # static register unroll above this -> table loop
MAX_TABLE_SEGMENTS = 8192  # geometry table budget
EXIT_CHECK = 16            # plain-path drain check cadence (steps): the
                           # early-exit cross-lane reduction runs once per
                           # EXIT_CHECK fori-unrolled steps; overshoot is
                           # masked no-ops, results bit-identical
_LANES = 128
_MAX_WARPS = 8  # one walker per thread up to 256 threads per block
_TWO_PI = 2.0 * np.pi

_INTERPRET = contextvars.ContextVar("pallas_walk_interpret", default=False)


@contextlib.contextmanager
def interpret_mode():
    """Run every kernel launch traced inside this block in Pallas's
    interpreter instead of compiling it for the GPU.

    This is the one switch that runs the kernel without a card: nothing
    chooses interpret mode from the platform, and outside this block
    ``backend="pallas"`` on a platform other than the GPU raises. The
    switch is read when a solve is traced, so a solver built and first
    called inside the block keeps its interpreted solve."""
    token = _INTERPRET.set(True)
    try:
        yield
    finally:
        _INTERPRET.reset(token)


def interpreting() -> bool:
    """True inside :func:`interpret_mode`."""
    return _INTERPRET.get()


def num_warps(block_rows: int) -> int:
    """Warps per kernel block: one walker per thread (``block_rows * 128``
    walkers over 32-thread warps), at most ``_MAX_WARPS``. In the H100
    block-size sweep one walker per thread was fastest at both 128 and
    256 walkers per block (PERF.md)."""
    return min(block_rows * _LANES // 32, _MAX_WARPS)


def _geometry_size(problem):
    n_seg = problem.dirichlet.num_segments
    n_vert = 0
    if problem.neumann is not None:
        n_seg += problem.neumann.num_segments
        n_vert = int(np.asarray(problem.neumann.vert_valid).sum())
    return n_seg + n_vert


def pallas_supported(problem) -> bool:
    """Small boundaries unroll into registers; larger ones loop over a
    segment table in device memory (up to ``MAX_TABLE_SEGMENTS``)."""
    return _geometry_size(problem) <= MAX_TABLE_SEGMENTS


def _static_segments(poly):
    """Extract segment endpoints as python-float tuples (static constants)."""
    a = np.asarray(poly.seg_a)[np.asarray(poly.seg_valid)]
    b = np.asarray(poly.seg_b)[np.asarray(poly.seg_valid)]
    return [
        (float(a[i, 0]), float(a[i, 1]), float(b[i, 0]), float(b[i, 1]))
        for i in range(len(a))
    ]


def _static_vertices(poly):
    abc = np.asarray(poly.vert_abc)[np.asarray(poly.vert_valid)]
    return [tuple(float(v) for v in abc[i].ravel()) for i in range(len(abc))]


def _false_like(x):
    # all-False mask shaped like x
    return x > jnp.float32(3.0e38)


def _to_unit_f32(h):
    """u32 hash -> [0, 1) float, identical numerics to
    ``rng.counter_uniform_lanes``'s ``(h >> 8) * 2^-24`` (the mantissa is
    < 2^24, so the int32 bitcast is value-preserving and the signed
    conversion is exact)."""
    mant = jax.lax.bitcast_convert_type(h >> 8, jnp.int32)
    return mant.astype(jnp.float32) * jnp.float32(2.0**-24)


def _mix32_u32(x):
    """``sampling.rng.mix32`` on register arrays, built from the SAME
    np.uint32 constants (one source of truth for the draw-for-draw
    XLA/Pallas invariant)."""
    from ..sampling.rng import MIX_M1, MIX_M2

    x = x ^ (x >> 16)
    x = x * MIX_M1
    x = x ^ (x >> 15)
    x = x * MIX_M2
    x = x ^ (x >> 16)
    return x


def _counter_uniform_2d(seed_u32, ctr_u32, sid_u32, streams):
    """Per-lane counter-hash uniforms on ``(rows, 128)`` register arrays.

    Bit-identical to ``sampling.rng.counter_uniform_lanes(seed, ctr,
    n, lane_ids)[k]`` for stream index ``k`` in ``streams`` (1-based like
    the XLA step's ``u`` rows): value = ``mix32(lane ^ C_STREAM*stream ^
    mix32(seed ^ C_COUNTER*ctr))``. Sharing the hash (and its constants)
    with the XLA backend is what makes kernel walks host-reproducible.
    """
    from ..sampling.rng import C_COUNTER, C_STREAM

    base = _mix32_u32(seed_u32 ^ (C_COUNTER * ctr_u32))
    return [
        _to_unit_f32(_mix32_u32(
            sid_u32 ^ np.uint32((int(C_STREAM) * k) & 0xFFFFFFFF) ^ base
        ))
        for k in streams
    ]


def _closest_point_unrolled(segs, px, py):
    big = jnp.float32(3e38)
    best = jnp.full_like(px, big)
    bcx = jnp.zeros_like(px)
    bcy = jnp.zeros_like(px)
    for (ax, ay, bx, by) in segs:
        ux, uy = bx - ax, by - ay
        uu = max(ux * ux + uy * uy, 1e-30)
        vx = px - ax
        vy = py - ay
        # DIVIDE like queries.closest_point — a reciprocal-multiply can
        # differ by 1 ulp, flipping dD at the eps shell and chaotically
        # desynchronizing matched-seed backend walks (CLAUDE.md)
        t = jnp.clip((vx * ux + vy * uy) / uu, 0.0, 1.0)
        cx = ax + t * ux
        cy = ay + t * uy
        d2 = (cx - px) ** 2 + (cy - py) ** 2
        pick = d2 < best
        best = jnp.where(pick, d2, best)
        bcx = jnp.where(pick, cx, bcx)
        bcy = jnp.where(pick, cy, bcy)
    return jnp.sqrt(best), bcx, bcy


def _chord_frame_unrolled(segs, px, py):
    """Nearest-segment chord frame over static unrolled segments.

    Mirrors ``geometry/queries.py::closest_point_chord`` for the Robin
    chord branch: returns the winning segment's unit tangent ``(tx, ty)``
    and the chord parameter interval ``[s_lo, s_hi]`` keeping
    ``foot + s * t_hat`` on that segment (support truncation of the chord
    integrand). The tangent is derived from the SEGMENT DATA in f32
    (np.float32 scalar arithmetic, like ``_first_hit_unrolled``'s
    normals) so it is bit-identical to the XLA path's.
    """
    big = jnp.float32(3e38)
    best = jnp.full_like(px, big)
    btx = jnp.zeros_like(px)
    bty = jnp.zeros_like(px)
    bslo = jnp.zeros_like(px)
    bshi = jnp.zeros_like(px)
    for (ax, ay, bx, by) in segs:
        ax32, ay32 = np.float32(ax), np.float32(ay)
        ux32 = np.float32(np.float32(bx) - ax32)
        uy32 = np.float32(np.float32(by) - ay32)
        uu32 = np.float32(np.maximum(
            ux32 * ux32 + uy32 * uy32, np.float32(1e-30)))
        ul32 = np.float32(np.sqrt(uu32))
        txs = float(np.float32(ux32 / ul32))
        tys = float(np.float32(uy32 / ul32))
        vx = px - float(ax32)
        vy = py - float(ay32)
        t = jnp.clip((vx * float(ux32) + vy * float(uy32)) / float(uu32),
                     0.0, 1.0)
        cx = float(ax32) + t * float(ux32)
        cy = float(ay32) + t * float(uy32)
        d2 = (cx - px) ** 2 + (cy - py) ** 2
        pick = d2 < best
        best = jnp.where(pick, d2, best)
        btx = jnp.where(pick, txs, btx)
        bty = jnp.where(pick, tys, bty)
        bslo = jnp.where(pick, -t * float(ul32), bslo)
        bshi = jnp.where(pick, (1.0 - t) * float(ul32), bshi)
    return btx, bty, bslo, bshi


def _silhouette_unrolled(verts, px, py):
    big = jnp.float32(3e38)
    best = jnp.full_like(px, big)
    for (axv, ayv, bxv, byv, cxv, cyv) in verts:
        abx, aby = bxv - axv, byv - ayv
        bcx_, bcy_ = cxv - bxv, cyv - byv
        apx = px - axv
        apy = py - ayv
        bpx = px - bxv
        bpy = py - byv
        s = (abx * apy - aby * apx) * (bcx_ * bpy - bcy_ * bpx)
        d2 = bpx * bpx + bpy * bpy
        best = jnp.where(s < 0, jnp.minimum(best, d2), best)
    return jnp.sqrt(best)


def _first_hit_unrolled(segs, px, py, dx, dy, r, t_min):
    big = jnp.float32(3e38)
    t_best = jnp.full_like(px, big)
    nx = jnp.zeros_like(px)
    ny = jnp.zeros_like(px)
    hxs = jnp.zeros_like(px)
    hys = jnp.zeros_like(px)
    for (ax, ay, bx, by) in segs:
        ux, uy = bx - ax, by - ay
        # static CCW normal in float32 arithmetic, mirroring
        # queries.first_hit's f32 sqrt/divide bit-for-bit (a float64
        # np.hypot normal can differ by 1 ulp and rotate the hemisphere
        # direction of matched-seed walks)
        ux32, uy32 = np.float32(ux), np.float32(uy)
        ulen = np.float32(np.sqrt(np.float32(
            np.maximum(ux32 * ux32 + uy32 * uy32, np.float32(1e-30)))))
        nxs = float(np.float32(-uy32 / ulen))
        nys = float(np.float32(ux32 / ulen))
        wx = px - ax
        wy = py - ay
        den = dx * uy - dy * ux
        den_safe = jnp.where(jnp.abs(den) < 1e-30, 1e-30, den)
        inv_den = 1.0 / den_safe
        t = (ux * wy - uy * wx) * inv_den
        s = (dx * wy - dy * wx) * inv_den
        ok = (s >= 0.0) & (s <= 1.0) & (t >= t_min) & (jnp.abs(den) > 1e-30)
        t = jnp.where(ok, t, big)
        pick = t < t_best
        t_best = jnp.where(pick, t, t_best)
        nx = jnp.where(pick, nxs, nx)
        ny = jnp.where(pick, nys, ny)
        # exact on-segment hit point (see geometry/queries.py::first_hit)
        hxs = jnp.where(pick, ax + s * ux, hxs)
        hys = jnp.where(pick, ay + s * uy, hys)
    hit = t_best <= r
    t_hit = jnp.where(hit, t_best, r)
    # orient against the ray (inward)
    flip = (nx * dx + ny * dy) > 0.0
    nx = jnp.where(flip, -nx, nx)
    ny = jnp.where(flip, -ny, ny)
    nx = jnp.where(hit, nx, 0.0)
    ny = jnp.where(hit, ny, 0.0)
    hx = jnp.where(hit, hxs, px + r * dx)
    hy = jnp.where(hit, hys, py + r * dy)
    return hx, hy, nx, ny, t_hit, hit


_CHUNK = 32  # geometry-table loop unroll factor


def _closest_point_table(seg_ref, n_seg_pad, px, py):
    """Closest point over an ``(S, 4)`` segment table in device memory.

    fori over chunks of ``_CHUNK`` statically-unrolled segments (scalar
    reads by index, the same value for every lane of the block); the
    unroll amortizes the loop overhead. Padding segments are degenerate
    points at 1e30 and lose every min.
    """
    big = jnp.float32(3e38)

    def chunk(c, carry):
        best, bcx, bcy = carry
        for j in range(_CHUNK):
            i = c * _CHUNK + j
            ax = seg_ref[i, 0]
            ay = seg_ref[i, 1]
            ux = seg_ref[i, 2] - ax
            uy = seg_ref[i, 3] - ay
            vx = px - ax
            vy = py - ay
            # division (not reciprocal-multiply), matching
            # queries.closest_point bit-for-bit so interpret-mode kernel
            # walks equal the XLA backend's
            t = jnp.clip((vx * ux + vy * uy)
                         / jnp.maximum(ux * ux + uy * uy, 1e-30), 0.0, 1.0)
            cx = ax + t * ux
            cy = ay + t * uy
            d2 = (cx - px) ** 2 + (cy - py) ** 2
            pick = d2 < best
            best = jnp.where(pick, d2, best)
            bcx = jnp.where(pick, cx, bcx)
            bcy = jnp.where(pick, cy, bcy)
        return best, bcx, bcy

    init = (jnp.full_like(px, big), jnp.zeros_like(px), jnp.zeros_like(px))
    best, bcx, bcy = jax.lax.fori_loop(0, n_seg_pad // _CHUNK, chunk, init)
    return jnp.sqrt(best), bcx, bcy


def _chord_frame_table(seg_ref, n_seg_pad, px, py):
    """Chord frame (see ``_chord_frame_unrolled``) over a segment table.

    Padding segments are degenerate 1e30 points and lose every min, like
    ``_closest_point_table``.
    """
    big = jnp.float32(3e38)

    def chunk(c, carry):
        best, btx, bty, bslo, bshi = carry
        for j in range(_CHUNK):
            i = c * _CHUNK + j
            ax = seg_ref[i, 0]
            ay = seg_ref[i, 1]
            ux = seg_ref[i, 2] - ax
            uy = seg_ref[i, 3] - ay
            uu = jnp.maximum(ux * ux + uy * uy, 1e-30)
            ul = jnp.sqrt(uu)
            vx = px - ax
            vy = py - ay
            t = jnp.clip((vx * ux + vy * uy) / uu, 0.0, 1.0)
            cx = ax + t * ux
            cy = ay + t * uy
            d2 = (cx - px) ** 2 + (cy - py) ** 2
            pick = d2 < best
            best = jnp.where(pick, d2, best)
            btx = jnp.where(pick, ux / ul, btx)
            bty = jnp.where(pick, uy / ul, bty)
            bslo = jnp.where(pick, -t * ul, bslo)
            bshi = jnp.where(pick, (1.0 - t) * ul, bshi)
        return best, btx, bty, bslo, bshi

    z = jnp.zeros_like(px)
    init = (jnp.full_like(px, big), z, z, z, z)
    _, btx, bty, bslo, bshi = jax.lax.fori_loop(
        0, n_seg_pad // _CHUNK, chunk, init)
    return btx, bty, bslo, bshi


def _silhouette_table(vert_ref, n_vert_pad, px, py):
    big = jnp.float32(3e38)

    def chunk(c, best):
        for j in range(_CHUNK):
            i = c * _CHUNK + j
            axv = vert_ref[i, 0]
            ayv = vert_ref[i, 1]
            bxv = vert_ref[i, 2]
            byv = vert_ref[i, 3]
            cxv = vert_ref[i, 4]
            cyv = vert_ref[i, 5]
            abx, aby = bxv - axv, byv - ayv
            bcx_, bcy_ = cxv - bxv, cyv - byv
            apx = px - axv
            apy = py - ayv
            bpx = px - bxv
            bpy = py - byv
            sgn = (abx * apy - aby * apx) * (bcx_ * bpy - bcy_ * bpx)
            d2 = bpx * bpx + bpy * bpy
            best = jnp.where(sgn < 0, jnp.minimum(best, d2), best)
        return best

    best = jax.lax.fori_loop(0, n_vert_pad // _CHUNK, chunk,
                             jnp.full_like(px, big))
    return jnp.sqrt(best)


def _first_hit_table(seg_ref, n_seg_pad, px, py, dx, dy, r, t_min):
    big = jnp.float32(3e38)

    def chunk(c, carry):
        t_best, nx, ny, hxs, hys = carry
        for j in range(_CHUNK):
            i = c * _CHUNK + j
            ax = seg_ref[i, 0]
            ay = seg_ref[i, 1]
            ux = seg_ref[i, 2] - ax
            uy = seg_ref[i, 3] - ay
            ulen = jnp.sqrt(jnp.maximum(ux * ux + uy * uy, 1e-30))
            nxs, nys = -uy / ulen, ux / ulen
            wx = px - ax
            wy = py - ay
            den = dx * uy - dy * ux
            den_safe = jnp.where(jnp.abs(den) < 1e-30, 1e-30, den)
            # divisions to match queries.first_hit bit-for-bit
            t = (ux * wy - uy * wx) / den_safe
            sp = (dx * wy - dy * wx) / den_safe
            ok = (sp >= 0.0) & (sp <= 1.0) & (t >= t_min) & (jnp.abs(den) > 1e-30)
            t = jnp.where(ok, t, big)
            pick = t < t_best
            t_best = jnp.where(pick, t, t_best)
            nx = jnp.where(pick, nxs, nx)
            ny = jnp.where(pick, nys, ny)
            # exact on-segment hit point (see queries.first_hit)
            hxs = jnp.where(pick, ax + sp * ux, hxs)
            hys = jnp.where(pick, ay + sp * uy, hys)
        return t_best, nx, ny, hxs, hys

    init = (jnp.full_like(px, big), jnp.zeros_like(px), jnp.zeros_like(px),
            jnp.zeros_like(px), jnp.zeros_like(px))
    t_best, nx, ny, hxs, hys = jax.lax.fori_loop(
        0, n_seg_pad // _CHUNK, chunk, init)
    hit = t_best <= r
    t_hit = jnp.where(hit, t_best, r)
    flip = (nx * dx + ny * dy) > 0.0
    nx = jnp.where(flip, -nx, nx)
    ny = jnp.where(flip, -ny, ny)
    nx = jnp.where(hit, nx, 0.0)
    ny = jnp.where(hit, ny, 0.0)
    hx = jnp.where(hit, hxs, px + r * dx)
    hy = jnp.where(hit, hys, py + r * dy)
    return hx, hy, nx, ny, t_hit, hit


def _pad_table(table):
    """Pad a geometry table to power-of-two rows (at least ``_CHUNK``) and
    columns with degenerate 1e30 entries (same convention as Polyline's
    own padding: they lose every min and fail every hit test). Triton
    blocks are powers of two, and the chunk loops iterate
    ``rows / _CHUNK`` times, so a table only padded to Polyline's
    multiple-of-8 would have its trailing real rows silently skipped.
    """
    n, c = table.shape
    n_pad = max(_CHUNK, 1 << (n - 1).bit_length())
    c_pad = 1 << (c - 1).bit_length()
    if (n_pad, c_pad) == (n, c):
        return table
    out = np.full((n_pad, c_pad), 1e30, np.float32)
    out[:n, :c] = table
    return out


def _seg_table(poly):
    """(S_pad, 4) float32 [ax, ay, bx, by] incl. degenerate padding rows."""
    a = np.asarray(poly.seg_a, np.float32)
    b = np.asarray(poly.seg_b, np.float32)
    return _pad_table(np.concatenate([a, b], axis=1))


def _vert_table(poly):
    """(V_pad, 8) float32 [a, b, c] triples incl. padding rows and two
    unused padding columns."""
    return _pad_table(
        np.asarray(poly.vert_abc, np.float32).reshape(len(poly.vert_abc), 6)
    )


def stream_ids(rows: int, crn=None):
    """Per-lane RNG stream ids for a ``(rows, 128)`` state block,
    mirroring the XLA path's ``_lane_ids``: the lane index itself, or the
    slot-matched CRN mapping ``(mode, period, reps)``."""
    ids = np.arange(rows * _LANES, dtype=np.uint32)
    if crn is not None:
        mode, period, reps = crn
        if mode == "tile":      # point-major layout: lane = p*K + j
            ids = ids % np.uint32(period)
        else:                   # slot-major: lane = j*P + p
            ids = ids // np.uint32(reps)
    return jnp.asarray(ids.astype(np.int32).reshape(rows, _LANES))


class PallasWalkPlan(NamedTuple):
    run: callable      # (state_dict, seed) -> new state; ``seed`` is the
                       # int32 bit pattern of the XLA-path stream seed and
                       # is FIXED across launches (per-lane walk/step
                       # counters advance, not the seed)
    block_rows: int
    n_inner: int


def make_pallas_walk(
    problem,
    eps: float,
    max_steps: int,
    t_min: float,
    rmin: float,
    project: bool,
    n_inner: int = 256,
    block_rows: int = 1,
    rejection_rounds: int = 64,
    screened_sampler: str = "exact",  # "exact" (rejection) | "transport"
                                      # (map + IS weight) — shared samplers
                                      # from sampling/radial.py, identical
                                      # draws to the XLA step
    max_attenuation=None,
    robin_correction=False,  # False | True/"chain" | "reflectance"
                             # (pre-RESOLVED: pass "auto" through
                             # WoStSolver._robin_enabled, not here)
    roulette_threshold=None,
    robin_arrival_clamp=0.02,  # grazing cos(phi) floor of the Robin
                               # arrival weight (SolverOptions, mirrored)
    snap_starts=False,       # boundary_snap on-boundary starts: state
                             # carries per-lane ob0/n0x/n0y and recycled
                             # walks restart on the wall (solver/wost.py
                             # _snap_points; THEORY.md 4g)
    freeze_split=False,      # in-launch high-weight FREEZE: lanes whose
                             # |atten| exceeds a per-launch scalar
                             # stop stepping until the host-loop split
                             # halves them at the launch boundary. Without
                             # it the launch-boundary split lets weights
                             # compound unchecked for n_inner steps (the
                             # XLA path splits every 16); measured on the
                             # notebook survey, single walks reached
                             # |atten|~1e10 within one 256-step launch.
                             # Frozen lanes draw nothing and advance no
                             # counters, so resumed walks are bit-identical
                             # (launch-partitioning invariance). The host
                             # passes +inf to fail OPEN (no freeze) when
                             # every active lane is heavy and no idle lane
                             # can host a clone — guaranteeing drain.
):
    """Build the fused multi-step kernel.

    Returns a jittable ``launch(state_dict, seed) -> state_dict`` advancing
    every walker by ``n_inner`` steps. State arrays are ``(rows, 128)``
    float32/int32 with rows a multiple of ``block_rows`` (a power of two:
    one grid block holds ``block_rows * 128`` walkers, run by
    :func:`num_warps` warps).

    Randomness mirrors the XLA step (``solver/wost.py::_make_step_core``
    with ``rng='fast'``) draw-for-draw: uniform ``u[i]`` of the XLA path is
    hash stream ``i + 1`` keyed on the per-lane counter
    ``n_done * (max_steps + 2) + steps``, and the screened-radius rejection
    uses the same round-seeded streams through the shared
    ``sampling.radial._exact_rejection``. Stream ids are supplied by the
    caller in ``state['sid']`` (see :func:`stream_ids`): kernel walks are
    reproducible regardless of how steps are partitioned into launches or
    how lanes are permuted by compaction, and CRN layouts work on the fast
    path (stream id = slot id instead of lane id).
    """
    from ..sampling.radial import (
        _exact_rejection,
        sample_greens_radius,
        sample_screened_radius_transport,
    )
    from .greens import (
        greens_2d,
        greens_norm_2d,
        screened_chord_integral,
        screened_greens_2d,
        screened_greens_norm_2d,
        screened_greens_wall_ratio,
        screened_interior_prob,
    )

    pb = problem
    use_delta = pb.use_delta_tracking
    has_neumann = pb.neumann is not None
    source_fields = pb.source_fields
    has_source = len(source_fields) > 0
    n_src = max(1, len(source_fields))
    # python float, NOT jnp.float32: pallas kernels cannot capture
    # pre-created array constants; in-trace f32 conversion is identical
    sigma_bar_f = float(pb.sigma_bar) if use_delta else None
    local_mj = pb.local_majorant if use_delta else None
    if local_mj is not None:
        sb_bg_f = float(max(local_mj.sigma_bar_bg, 1e-12))
        mfp_bg_f = float(1.0 / np.sqrt(max(local_mj.sigma_bar_bg, 1e-12)))
        mfp_gl_f = float(1.0 / np.sqrt(max(pb.sigma_bar, 1e-30)))
    importance = pb.source_importance
    use_mis = has_source and importance is not None
    if use_mis:
        # static mixture constants (unrolled component selection / pdf);
        # cumsum in float32 to match GaussianMixture.sample's jnp.cumsum
        mis_cx = [float(v) for v in np.asarray(importance.cx)]
        mis_cy = [float(v) for v in np.asarray(importance.cy)]
        mis_w = [float(v) for v in np.asarray(importance.width)]
        mis_a = [float(v) for v in np.asarray(importance.weight)]
        mis_cum = [
            float(v)
            for v in np.cumsum(np.asarray(importance.weight, np.float32))
        ]
    static_geom = _geometry_size(pb) <= MAX_UNROLL_SEGMENTS
    dir_segs = _static_segments(pb.dirichlet) if static_geom else []
    neu_segs = (_static_segments(pb.neumann)
                if has_neumann and static_geom else [])
    neu_verts = (_static_vertices(pb.neumann)
                 if has_neumann and static_geom else [])
    has_verts = (
        bool(neu_verts) if static_geom
        else has_neumann and int(np.asarray(pb.neumann.vert_valid).sum()) > 0
    )
    if not static_geom:
        dir_table = jnp.asarray(_seg_table(pb.dirichlet))
        neu_table = jnp.asarray(_seg_table(pb.neumann)) if has_neumann else None
        vert_table = jnp.asarray(_vert_table(pb.neumann)) if has_verts else None
        geom_inputs = [dir_table] + (
            [neu_table] if has_neumann else []
        ) + ([vert_table] if has_verts else [])
    else:
        geom_inputs = []
    n_geom = len(geom_inputs)

    def _lift2d(f):
        # scalar fields (incl. jax.grad-built sigma', which requires scalar
        # tracing) applied to (rows, 128) register arrays via double vmap
        return jax.vmap(jax.vmap(
            lambda x, y: jnp.asarray(f(x, y), jnp.float32) + 0.0 * x
        ))

    bc = _lift2d(pb.bc_dirichlet)
    sources = [_lift2d(f) for f in source_fields]
    alpha_c = _lift2d(pb.alpha_c) if use_delta else None
    sigma_prime = _lift2d(pb.sigma_prime) if use_delta else None
    # robin_correction: False | "chain" (legacy True) | "reflectance",
    # mirroring WoStSolver._robin_enabled's resolved modes
    use_robin = use_delta and has_neumann and bool(robin_correction)
    robin_chain = use_robin and robin_correction != "reflectance"
    if use_robin:
        grad_log_alpha_x = _lift2d(lambda x, y: pb.grad_log_alpha(x, y)[0])
        grad_log_alpha_y = _lift2d(lambda x, y: pb.grad_log_alpha(x, y)[1])
    # python-float constants (pallas kernels may not capture array consts)
    eps_f = float(eps)
    rmin_f = float(rmin)
    # same static branch-rate floor as solver/wost.py (deterministic
    # probe, so both backends see the identical value)
    gamma_floor_f = float(0.25 * pb.max_boundary_gamma()) \
        if use_robin else 0.0
    t_min_f = float(t_min)

    # stream indices mirroring the XLA path's u[i] <-> stream i+1 layout
    need_greens_radius = (not use_delta) and (has_source or use_mis)
    main_streams = [1]
    if need_greens_radius:
        main_streams += [2, 3]
    if use_delta:
        main_streams += [4]
    if use_mis:
        main_streams += [5, 6, 7, 8]
    if robin_chain:
        main_streams += [9, 10, 11]  # chord branch / side+U1 / technique+U2
        # (reflectance mode is draw-free: same streams as robin-off)

    def kernel(*refs):
        seed_ref = refs[0]
        ni_ref = refs[1]  # per-launch step budget (i32 (1,)): a
                          # RUNTIME scalar so adaptive launch sizing
                          # (SolverOptions.adaptive_launches) can vary the
                          # launch length without recompiling the kernel;
                          # non-adaptive callers pass the static n_inner
        gi = 2
        if freeze_split:
            thr_ref = refs[2]
            gi = 3
        if not static_geom:
            dir_seg_ref = refs[gi]
            gi += 1
            if has_neumann:
                neu_seg_ref = refs[gi]
                gi += 1
            if has_verts:
                neu_vert_ref = refs[gi]
                gi += 1
        p0x_ref, p0y_ref, sid_ref = refs[gi], refs[gi + 1], refs[gi + 2]
        gi2 = gi + 3
        if snap_starts:
            ob0_ref, n0x_ref, n0y_ref = refs[gi2], refs[gi2 + 1], refs[gi2 + 2]
            gi2 += 3
        n_state = 5 + 3 * n_src + 9
        sin = refs[gi2: gi2 + n_state]
        sout = refs[gi2 + n_state: gi2 + 2 * n_state]
        (px_ref, py_ref, nx_ref, ny_ref, atten_ref) = sin[:5]
        acc_refs = sin[5: 5 + n_src]
        asum_refs = sin[5 + n_src: 5 + 2 * n_src]
        asq_refs = sin[5 + 2 * n_src: 5 + 3 * n_src]
        (quota_ref, steps_ref, ndone_ref, ob_ref, life_ref,
         tn_ref, tw_ref, wmax_ref, bmax_ref) = sin[5 + 3 * n_src:]
        (opx_ref, opy_ref, onx_ref, ony_ref, oatten_ref) = sout[:5]
        oacc_refs = sout[5: 5 + n_src]
        oasum_refs = sout[5 + n_src: 5 + 2 * n_src]
        oasq_refs = sout[5 + 2 * n_src: 5 + 3 * n_src]
        (oquota_ref, osteps_ref, ondone_ref, oob_ref, olife_ref,
         otn_ref, otw_ref, owmax_ref, obmax_ref) = sout[5 + 3 * n_src:]

        if static_geom:
            closest_point = lambda px, py: _closest_point_unrolled(
                dir_segs, px, py)
            silhouette = lambda px, py: _silhouette_unrolled(
                neu_verts, px, py)
            first_hit = lambda px, py, dx, dy, r, tm: _first_hit_unrolled(
                neu_segs, px, py, dx, dy, r, tm)
            if robin_chain:
                chord_frame = lambda px, py: _chord_frame_unrolled(
                    neu_segs, px, py)
        else:
            n_dir = dir_table.shape[0]
            closest_point = lambda px, py: _closest_point_table(
                dir_seg_ref, n_dir, px, py)
            if has_verts:
                n_vert = vert_table.shape[0]
                silhouette = lambda px, py: _silhouette_table(
                    neu_vert_ref, n_vert, px, py)
            if has_neumann:
                n_neu = neu_table.shape[0]
                first_hit = lambda px, py, dx, dy, r, tm: _first_hit_table(
                    neu_seg_ref, n_neu, px, py, dx, dy, r, tm)
                if robin_chain:
                    chord_frame = lambda px, py: _chord_frame_table(
                        neu_seg_ref, n_neu, px, py)

        # int32 -> uint32 is modular, so the seed's bit pattern survives
        # the int32 input even when the high bit is set
        seed_u32 = seed_ref[0].astype(jnp.uint32)
        sid_u32 = jax.lax.bitcast_convert_type(sid_ref[...], jnp.uint32)
        p0x = p0x_ref[...]
        p0y = p0y_ref[...]
        if snap_starts:
            ob0 = ob0_ref[...] != 0
            n0x = n0x_ref[...]
            n0y = n0y_ref[...]

        def step(_, carry):
            (px, py, nxv, nyv, atten, accs, asums, asqs, quota, steps,
             ndone, obi, life, tn, tw, wmax, bmax, *rest) = carry
            # cross-step alpha cache (delta only): alpha at the CURRENT
            # position rides the carry — every move below evaluates alpha
            # at its destination anyway, so the walker-position re-eval
            # is the one avoidable field eval of the hot loop (mirrors
            # solver/wost.py's WalkerState.a_cur)
            a_cur_in = rest[0] if use_delta else None
            accs, asums, asqs = list(accs), list(asums), list(asqs)
            # the on-boundary mask rides the loop carry as int32
            ob = obi != 0
            act = quota > 0

            # per-lane (walk#, step#) counter from the INCOMING state — the
            # same formula as the XLA fast path, so random sequences are
            # reproducible per walk and identical across backends
            ctr = (jax.lax.bitcast_convert_type(ndone, jnp.uint32)
                   * np.uint32(max_steps + 2)
                   + jax.lax.bitcast_convert_type(steps, jnp.uint32))
            u_list = _counter_uniform_2d(seed_u32, ctr, sid_u32, main_streams)
            u = dict(zip(main_streams, u_list))

            dD, cx, cy = closest_point(px, py)
            done_eps = dD <= eps_f
            walk_done = act & (done_eps | (steps >= max_steps))
            if project:
                bx = jnp.where(done_eps, cx, px)
                by = jnp.where(done_eps, cy, py)
            else:
                bx, by = px, py
            g_bc = bc(bx, by) * atten
            # SELECT, not multiply-by-mask: 0 * NaN = NaN, so a non-finite
            # BC/source eval on an inactive or padded lane (frozen at
            # p0 = (0,0), possibly outside the domain) would permanently
            # poison the accumulators; the XLA step uses jnp.where for the
            # same reason
            bank_mag = jnp.zeros_like(g_bc)
            for i in range(n_src):
                contrib = accs[i] + g_bc
                asums[i] = asums[i] + jnp.where(walk_done, contrib, 0.0)
                asqs[i] = asqs[i] + jnp.where(
                    walk_done, contrib * contrib, 0.0)
                bank_mag = jnp.maximum(bank_mag, jnp.abs(contrib))
            # heaviest banked walk total (max over sources): the
            # variance-domination tripwire read by solve()'s guard
            # (mirrors solver/wost.py's WalkerState.bmax)
            bmax = jnp.maximum(
                bmax, jnp.where(walk_done, bank_mag, 0.0))
            ndone = ndone + walk_done.astype(jnp.int32)
            quota = quota - walk_done.astype(jnp.int32)

            # truncation accounting (mirrors solver/wost.py): walks the
            # max_steps cap ended while still carrying weight — roulette
            # kills end with atten == 0 and are excluded. Accumulated
            # per lane, summed by the caller's _moments.
            truncated = walk_done & ~done_eps & (jnp.abs(atten) > 0.0)
            tn = tn + truncated.astype(jnp.float32)
            tw = tw + jnp.where(truncated, jnp.abs(atten), 0.0)

            px = jnp.where(walk_done, p0x, px)
            py = jnp.where(walk_done, p0y, py)
            for i in range(n_src):
                accs[i] = jnp.where(walk_done, 0.0, accs[i])
            atten = jnp.where(walk_done, 1.0, atten)
            if snap_starts:
                # boundary_snap: recycled walks at snapped points restart
                # ON the wall with their start normal (solver/wost.py
                # p0ob/p0nx/p0ny, THEORY.md 4g)
                ob = (walk_done & ob0) | (ob & ~walk_done)
                nxv = jnp.where(walk_done, n0x, nxv)
                nyv = jnp.where(walk_done, n0y, nyv)
            else:
                ob = ob & ~walk_done
            steps = jnp.where(walk_done, 0, steps)
            stepping = act & ~walk_done
            if freeze_split:
                # heavy lanes wait for the launch-boundary split instead of
                # compounding further; they draw nothing and advance no
                # counters, so the resumed walk is bit-identical. Recycled
                # lanes were just reset to atten=1 above (and walk_done
                # already excludes them this iteration).
                stepping = stepping & (jnp.abs(atten) <= thr_ref[0])

            if has_neumann and has_verts:
                d_sil = silhouette(px, py)
                r = jnp.maximum(rmin_f, jnp.minimum(dD, d_sil))
            else:
                r = jnp.maximum(rmin_f, dD)

            # two-level local majorant, mirroring solver/wost.py op-for-op
            # (same placement, same progress heuristic; region constants
            # unroll into a few register selects)
            if use_delta and local_mj is not None:
                d_far = local_mj.distance(px, py)
                rB = jnp.minimum(r, d_far)
                useB = (d_far >= rmin_f) & (
                    jnp.minimum(rB, mfp_bg_f) > jnp.minimum(r, mfp_gl_f))
                r = jnp.where(useB, rB, r)
                sbar = jnp.where(useB, sb_bg_f, sigma_bar_f)
            elif use_delta:
                sbar = jnp.full_like(r, sigma_bar_f)

            if use_robin:
                # on-boundary Robin chord mass c = 4 gamma J(r), mirroring
                # solver/wost.py op-for-op (same placement right after the
                # star radius so the attenuation multiply order matches
                # bit-for-bit); the on-boundary radius is shrunk until
                # |c| <= 1/2. Reflectance folds 1/(1-c) deterministically;
                # chain uses c as the branch probability below.
                glx0 = grad_log_alpha_x(px, py)
                gly0 = grad_log_alpha_y(px, py)
                gamma0 = -0.5 * (nxv * glx0 + nyv * gly0)
                # rate floor + gamma(z) branch weight: mirrors
                # solver/wost.py op-for-op (see the rationale there)
                g_eff = jnp.maximum(jnp.abs(gamma0), gamma_floor_f)
                chord_j = screened_chord_integral(r, sbar)
                c_mag = 4.0 * g_eff * chord_j
                for _ in range(4):
                    shrink = ob & (c_mag > 0.5)
                    r_new = jnp.maximum(
                        rmin_f,
                        r * (0.5 / jnp.maximum(c_mag, 1e-12)))
                    r = jnp.where(shrink, r_new, r)
                    chord_j = jnp.where(
                        shrink, screened_chord_integral(r, sbar),
                        chord_j)
                    c_mag = jnp.where(shrink, 4.0 * g_eff * chord_j, c_mag)
                c_ch = 4.0 * gamma0 * chord_j
                c_mag = jnp.where(ob, jnp.minimum(c_mag, 0.9), 0.0)
                c_ch = jnp.where(ob, jnp.clip(c_ch, -0.9, 0.9), 0.0)
                if not robin_chain:
                    atten = jnp.where(
                        stepping & ob, atten / (1.0 - c_ch), atten)

            # ONE sin/cos pair at phi = pi u serves both the free direction
            # (theta = 2 phi via double angle) and the on-boundary
            # hemisphere rotation (beta = pi (u - 1/2): cos b = sin phi,
            # sin b = -cos phi)
            phi = jnp.pi * u[1]
            cphi = jnp.cos(phi)
            sphi = jnp.sin(phi)
            dx = 1.0 - 2.0 * sphi * sphi      # cos(2 phi)
            dy = 2.0 * sphi * cphi            # sin(2 phi)
            if has_neumann:
                cb = sphi
                sb = -cphi
                hdx = nxv * cb - nyv * sb
                hdy = nyv * cb + nxv * sb
                dx = jnp.where(ob, hdx, dx)
                dy = jnp.where(ob, hdy, dy)

            if has_neumann:
                # t_min self-hit guard only for on-boundary walkers (see
                # solver/wost.py): free walkers must catch ANY positive hit
                # or they tunnel through the surface from within t_min
                t_min_w = jnp.where(ob, t_min_f, 0.0)
                hx, hy, hnx, hny, t_hit, hit = first_hit(
                    px, py, dx, dy, r, t_min_w)
            else:
                hx = px + r * dx
                hy = py + r * dy
                hnx = jnp.zeros_like(px)
                hny = jnp.zeros_like(px)
                t_hit = r
                hit = _false_like(px)

            if use_delta:
                # same round-seeded streams as the XLA fast path's draw_r,
                # through the SHARED samplers (draw-for-draw backend
                # invariant): either the two-regime rejection with the
                # importance-weighted final round, or the loop-free
                # transport map + exact IS weight
                def draw_r(round_idx):
                    # a list of 4 planes, not a stacked array: the
                    # samplers only index it, and Triton has no
                    # concatenate/slice for (4, rows, 128) values
                    sd = (seed_u32 ^ np.uint32(0xA5A5A5A5)
                          ^ (jnp.asarray(round_idx).astype(jnp.uint32)
                             * np.uint32(0x68E31DA4)))
                    return _counter_uniform_2d(sd, ctr, sid_u32,
                                               [1, 2, 3, 4])

                if screened_sampler == "transport":
                    r_s, w_rej = sample_screened_radius_transport(
                        draw_r, r, sbar)
                else:
                    r_s, w_rej = _exact_rejection(draw_r, r, sbar,
                                                  rejection_rounds,
                                                  with_weight=True)
                atten = jnp.where(stepping, atten * w_rej, atten)
            elif need_greens_radius:
                r_s = sample_greens_radius(r, u[2], u[3])
            else:
                r_s = r
            beyond = r_s > t_hit
            sx = jnp.where(beyond, hx, px + r_s * dx)
            sy = jnp.where(beyond, hy, py + r_s * dy)

            if use_delta:
                # recycled lanes restart at p0 (launch-level a_p0); other
                # lanes carry the alpha their own move evaluated last step
                a_p = jnp.where(walk_done, a_p0, a_cur_in)
                a_s = alpha_c(sx, sy)

            if has_source and not use_mis:
                if use_delta:
                    w_src = (screened_greens_norm_2d(r, sbar)
                             / jnp.sqrt(a_s * a_p) * atten)
                else:
                    w_src = greens_norm_2d(r)
                # one shared NEE sample, one field eval per source
                live = stepping & ~beyond
                w_eff = jnp.where(live, w_src, 0.0)
                for i in range(n_src):
                    accs[i] = accs[i] + jnp.where(
                        live, sources[i](sx, sy) * w_eff, 0.0)
            elif use_mis:
                # source-directed MIS NEE (see solver/wost.py): sample from
                # 0.5 * ball-Green's + 0.5 * static Gaussian mixture
                take_src = u[5] < 0.5
                # unrolled component pick: idx = #{i: u > cum_i}, the exact
                # selection rule of GaussianMixture.sample
                mx = jnp.full_like(px, mis_cx[0])
                my = jnp.full_like(px, mis_cy[0])
                mw = jnp.full_like(px, mis_w[0])
                for ci in range(1, len(mis_cx)):
                    passed = u[6] > mis_cum[ci - 1]
                    mx = jnp.where(passed, mis_cx[ci], mx)
                    my = jnp.where(passed, mis_cy[ci], my)
                    mw = jnp.where(passed, mis_w[ci], mw)
                rad = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u[7], 1e-12)))
                ang = (2.0 * jnp.pi) * u[8]
                mx = mx + mw * rad * jnp.cos(ang)
                my = my + mw * rad * jnp.sin(ang)
                gx = px + r_s * dx
                gy = py + r_s * dy
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
                    _, _, _, _, t_y, hit_y = first_hit(px, py, ydx, ydy,
                                                       d_y, t_min_w)
                    in_star = in_ball & ~(hit_y & (t_y < d_y))
                else:
                    in_star = in_ball
                # static-mixture pdf (GaussianMixture.pdf unrolled)
                q = jnp.zeros_like(px)
                for ci in range(len(mis_cx)):
                    w2 = mis_w[ci] * mis_w[ci]
                    q = q + mis_a[ci] * jnp.exp(
                        -((yx - mis_cx[ci]) ** 2 + (yy - mis_cy[ci]) ** 2)
                        / (2.0 * w2)
                    ) / (float(_TWO_PI) * w2)
                # hemisphere-direction density doubling for on-boundary
                # walkers (see solver/wost.py MIS block)
                m_ob = 1.0 + ob.astype(jnp.float32)
                p_ball = jnp.where(in_ball, m_ob * g_val / norm, 0.0)
                p_mix = 0.5 * p_ball + 0.5 * q
                w_mis = jnp.where(
                    in_star & (p_mix > 1e-30),
                    m_ob * g_val / jnp.maximum(p_mix, 1e-30), 0.0,
                )
                if use_delta:
                    a_y = alpha_c(yx, yy)
                    w_mis = w_mis / jnp.sqrt(a_y * a_p) * atten
                w_mis = jnp.where(stepping, w_mis, 0.0)
                # (field evals selected below for the same NaN-poison
                # immunity as the accumulator update)
                for i in range(n_src):
                    accs[i] = accs[i] + jnp.where(
                        stepping, sources[i](yx, yy) * w_mis, 0.0)

            if use_delta:
                p_int = screened_interior_prob(r, sbar)
                interior = u[4] < p_int
                # wall-arrival semantics mirror solver/wost.py (scheme +
                # rationale documented there): an interior-sampled radius
                # reaching the hit is a boundary arrival with the edge
                # weight and the on-boundary flag
                collide = interior & ~(hit & (r_s >= t_hit - t_min_f))
                a_s_mv = a_s  # alpha at (sx, sy), computed once above
                a_h = alpha_c(hx, hy)
                sp_s = sigma_prime(sx, sy)
                # SIGNED null-collision factor — NO zero clamp, exactly as
                # solver/wost.py (weighted delta tracking: unbiased even
                # when sigma' locally exceeds the majorant)
                scale_int = jnp.sqrt(a_s_mv / a_p) * (1.0 - sp_s / sbar)
                scale_edge = jnp.sqrt(a_h / a_p)
                atten_pre = atten  # chord-branch lanes skip the move scale
                if use_robin:
                    # experimental Robin wall weight (see
                    # screened_greens_wall_ratio and solver/wost.py)
                    glx = grad_log_alpha_x(hx, hy)
                    gly = grad_log_alpha_y(hx, hy)
                    gamma = -0.5 * (hnx * glx + hny * gly)
                    cosphi = jnp.maximum(-(dx * hnx + dy * hny),
                                         float(robin_arrival_clamp))
                    rho = screened_greens_wall_ratio(t_hit, r, sbar)
                    # SIGNED arrival weight (no zero clamp), exactly as
                    # solver/wost.py
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
                a_next = jnp.where(collide, a_s, a_h)  # alpha cache feed
                new_ob = hit & ~collide
                if robin_chain:
                    # on-boundary chord continuation, mirroring
                    # solver/wost.py (same streams 9/10/11, same balanced
                    # log/exponential mixture sampler, same q = min(1/2,
                    # |c|) branch rate from the chord mass computed above)
                    q_scr = jnp.sqrt(jnp.maximum(sbar, 1e-12))
                    q_c = jnp.where(
                        ob, jnp.minimum(0.5, c_mag), 0.0)
                    branch = stepping & (u[9] < q_c) & (q_c > 1e-6)
                    side = jnp.where(u[10] < 0.5, -1.0, 1.0)
                    v = jnp.abs(2.0 * u[10] - 1.0)      # U1
                    tech_log = u[11] < 0.5              # technique selector
                    u2 = jnp.abs(2.0 * u[11] - 1.0)     # U2
                    z_log = r * jnp.maximum(v * u2, 1e-12)
                    trunc = 1.0 - jnp.exp(-q_scr * r)
                    z_exp = -jnp.log(
                        jnp.maximum(1.0 - v * trunc, 1e-12)) / q_scr
                    az = jnp.minimum(jnp.where(tech_log, z_log, z_exp), r)
                    zeta = side * az
                    p_log = -jnp.log(jnp.maximum(az / r, 1e-12)) / (2.0 * r)
                    p_exp = q_scr * jnp.exp(-q_scr * az) / (
                        2.0 * jnp.maximum(trunc, 1e-12))
                    p_mix = 0.5 * (p_log + p_exp)
                    g_ch = jnp.maximum(
                        screened_greens_2d(az, r, sbar), 0.0)
                    # chord laid along the EXACT segment tangent through
                    # the walker (on-boundary lanes stand on the wall, so
                    # foot == walker), with the integrand's support ending
                    # at the segment's ends — mirroring solver/wost.py /
                    # queries.closest_point_chord op-for-op
                    t_cx, t_cy, s_lo, s_hi = chord_frame(px, py)
                    zx = px + zeta * t_cx
                    zy = py + zeta * t_cy
                    # gamma AT the sampled chord point z (the identity's
                    # integrand is gamma(z) 2 G_s u~(z); freezing gamma
                    # at the walker biases varying-gamma walls)
                    glxz = grad_log_alpha_x(zx, zy)
                    glyz = grad_log_alpha_y(zx, zy)
                    gamma_z = -0.5 * (nxv * glxz + nyv * glyz)
                    # the branch is a MOVE x -> z of the u~-space walker:
                    # carry the transform factor sqrt(alpha_z / alpha_x)
                    # exactly like scale_int/scale_edge (solver/wost.py)
                    a_z = alpha_c(zx, zy)
                    w_ch = (2.0 * gamma_z * g_ch
                            / jnp.maximum(p_mix, 1e-30)
                            * jnp.sqrt(a_z / a_p))
                    # zero weight past the wall segment's support (the
                    # branch still happens; see solver/wost.py)
                    w_ch = jnp.where(
                        (zeta >= s_lo) & (zeta <= s_hi), w_ch, 0.0)
                    newx = jnp.where(branch, zx, newx)
                    newy = jnp.where(branch, zy, newy)
                    a_next = jnp.where(branch, a_z, a_next)
                    new_ob = new_ob | branch
                    atten = jnp.where(
                        branch,
                        atten_pre * w_ch / jnp.maximum(q_c, 1e-6),
                        atten * jnp.where(
                            stepping & ob & (q_c > 1e-6),
                            1.0 / (1.0 - q_c), 1.0))
                if max_attenuation is not None:
                    # symmetric: chord weights can be negative
                    atten = jnp.clip(atten, -float(max_attenuation),
                                     float(max_attenuation))
            else:
                newx, newy = hx, hy
                new_ob = hit

            px = jnp.where(stepping, newx, px)
            py = jnp.where(stepping, newy, py)
            # boolean blend via logical algebra
            ob = (stepping & new_ob) | (~stepping & ob)
            upd_n = stepping & hit
            if robin_chain:
                upd_n = upd_n & ~branch  # chord stays on its own wall
            nxv = jnp.where(upd_n, hnx, nxv)
            nyv = jnp.where(upd_n, hny, nyv)
            steps = steps + stepping.astype(jnp.int32)

            if use_delta and roulette_threshold is not None:
                # low-weight Russian roulette, mirroring solver/wost.py
                # (same dedicated hash stream, same survivor upweight)
                thr = float(roulette_threshold)
                u_r = _counter_uniform_2d(
                    seed_u32 ^ np.uint32(0x0F1E2D3C), ctr, sid_u32, [1]
                )[0]
                low = stepping & (jnp.abs(atten) < thr)
                survive = u_r * thr < jnp.abs(atten)
                atten = jnp.where(
                    low,
                    jnp.where(survive,
                              jnp.where(atten < 0.0, -thr, thr), 0.0),
                    atten,
                )
                steps = jnp.where(low & ~survive, max_steps, steps)

            # per-lane lifetime counter: summed outside the kernel for the
            # walker-steps throughput metric
            life = life + stepping.astype(jnp.int32)
            # running max |weight| of stepping lanes: the supercritical-
            # compounding tripwire (solve() warns when the solve's max
            # exceeds ~1e3x the split scale — robin_interior="chord"
            # blowups, mid-launch compounding, any future weighted option)
            wmax = jnp.maximum(
                wmax, jnp.where(stepping, jnp.abs(atten), 0.0))
            if use_delta:
                a_cur_out = jnp.where(
                    stepping, a_next, jnp.where(walk_done, a_p0, a_cur_in))
                tail = (a_cur_out,)
            else:
                tail = ()
            return (px, py, nxv, nyv, atten, tuple(accs), tuple(asums),
                    tuple(asqs), quota, steps, ndone, ob.astype(jnp.int32),
                    life, tn, tw, wmax, bmax) + tail

        # launch-level alpha evals, amortized over the n_inner steps: the
        # start-point alpha (recycle resets) and the incoming positions'
        # alpha (carry init — positions at launch boundaries are mid-walk)
        if use_delta:
            a_p0 = alpha_c(p0x, p0y)
            cache_init = (alpha_c(px_ref[...], py_ref[...]),)
        else:
            cache_init = ()
        carry = (
            px_ref[...], py_ref[...], nx_ref[...], ny_ref[...],
            atten_ref[...],
            tuple(ref[...] for ref in acc_refs),
            tuple(ref[...] for ref in asum_refs),
            tuple(ref[...] for ref in asq_refs),
            quota_ref[...], steps_ref[...], ndone_ref[...], ob_ref[...],
            life_ref[...], tn_ref[...], tw_ref[...], wmax_ref[...],
            bmax_ref[...],
        ) + cache_init

        # early exit when THIS block's quota is fully drained: a step with
        # no active lane mutates nothing (all updates are stepping/act
        # masked), so skipping the remaining inner iterations is exactly
        # the same computation, and short-walk workloads (total quota *
        # walk length << n_inner) do not burn the step budget as dead
        # steps. The block-wide jnp.max is cheap next to the step.
        ni = ni_ref[0]

        def inner_cond(c):
            i, cr = c
            if freeze_split:
                # a block whose every remaining active lane is frozen can
                # make no progress this launch (cr[4] = atten, cr[8] =
                # quota); thr = +inf degrades to the plain quota check
                steppable = ((cr[8] > 0)
                             & (jnp.abs(cr[4]) <= thr_ref[0])).astype(
                                 jnp.int32)
                return (i < ni) & (jnp.max(steppable) > 0)
            return (i < ni) & (jnp.max(cr[8]) > 0)  # cr[8] = quota

        def inner_body(c):
            i, cr = c
            return i + 1, step(i, cr)

        if freeze_split:
            # lanes freeze individually above the threshold, so the block
            # must re-evaluate steppability every iteration
            _, carry = jax.lax.while_loop(inner_cond, inner_body,
                                          (jnp.int32(0), carry))
        else:
            # plain path: amortize the cross-lane drain reduction over
            # EXIT_CHECK-step chunks. A step with no active lane mutates
            # nothing, so overshooting the drain point by <= EXIT_CHECK-1
            # masked no-op steps is EXACTLY the same computation (and ni
            # overshoot is covered by launch-partition invariance) —
            # results stay bit-identical to the per-step check.
            def chunk_body(c):
                i, cr = c
                cr = jax.lax.fori_loop(
                    0, EXIT_CHECK, lambda j, cc: step(i + j, cc), cr)
                return i + EXIT_CHECK, cr

            _, carry = jax.lax.while_loop(inner_cond, chunk_body,
                                          (jnp.int32(0), carry))
        (px, py, nxv, nyv, atten, accs, asums, asqs, quota, steps, ndone,
         obi, life, tn, tw, wmax, bmax, *_rest) = carry
        opx_ref[...] = px
        opy_ref[...] = py
        onx_ref[...] = nxv
        ony_ref[...] = nyv
        oatten_ref[...] = atten
        for i in range(n_src):
            oacc_refs[i][...] = accs[i]
            oasum_refs[i][...] = asums[i]
            oasq_refs[i][...] = asqs[i]
        oquota_ref[...] = quota
        osteps_ref[...] = steps
        ondone_ref[...] = ndone
        oob_ref[...] = obi
        olife_ref[...] = life
        otn_ref[...] = tn
        otw_ref[...] = tw
        owmax_ref[...] = wmax
        obmax_ref[...] = bmax

    f32 = jnp.float32
    i32 = jnp.int32

    def launch(state, seed, freeze_thr=None, inner_steps=None):
        """Advance all walkers by up to ``inner_steps`` (default
        ``n_inner``) steps.

        state: dict with keys p0x,p0y (f32), sid (i32 RNG stream ids —
        carried IN the state so walker compaction can permute lanes
        without changing their walks), px,py,nx,ny,atten,acc,asum,asq
        (f32), quota,steps,ndone,ob,life (i32), and the per-lane
        diagnostics tn,tw,wmax (f32: truncated-walk count, truncated
        |atten| mass, running max stepping |atten|) — all (rows, 128).
        ``seed`` is
        the int32-bit-pattern stream seed, constant across launches.
        ``freeze_thr`` (``freeze_split`` builds only): the per-launch
        |atten| freeze threshold — the host split's threshold normally,
        +inf to fail open when frozen lanes could starve (see the
        ``freeze_split`` parameter doc).
        """
        rows = state["px"].shape[0]
        grid = (rows // block_rows,)
        bspec = lambda: pl.BlockSpec((block_rows, _LANES), lambda i: (i, 0))
        # (1,) scalars and whole geometry tables: every block sees the
        # full array and reads it by scalar index
        whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
        order = (
            ["px", "py", "nx", "ny", "atten"]
            + [f"acc{i}" for i in range(n_src)]
            + [f"asum{i}" for i in range(n_src)]
            + [f"asq{i}" for i in range(n_src)]
            + ["quota", "steps", "ndone", "ob", "life"]
            + ["tn", "tw", "wmax", "bmax"]
        )
        dtypes = [f32] * (5 + 3 * n_src) + [i32] * 5 + [f32] * 4
        out_shape = [
            jax.ShapeDtypeStruct((rows, _LANES), dt) for dt in dtypes
        ]
        out_specs = [bspec() for _ in order]
        # constant per-lane inputs after seed + geometry: p0x, p0y, sid
        # (+ ob0, n0x, n0y when snap_starts)
        n_const = 3 + (3 if snap_starts else 0)
        snap_args = (
            [state["ob0"], state["n0x"], state["n0y"]] if snap_starts else []
        )
        n_pre = 3 if freeze_split else 2  # seed + inner budget (+ thr)
        ni_val = n_inner if inner_steps is None else inner_steps
        ni_arg = jnp.asarray(jnp.reshape(ni_val, (1,)), i32)
        thr_args = []
        if freeze_split:
            thr = jnp.inf if freeze_thr is None else freeze_thr
            thr_args = [jnp.asarray(jnp.reshape(thr, (1,)), f32)]
        # alias state inputs (after the constants) to outputs
        aliases = {n_pre + n_geom + n_const + k: k
                   for k in range(len(order))}
        pre_args = [jnp.asarray(jnp.reshape(seed, (1,)), i32), ni_arg,
                    *thr_args]
        outs = pl.pallas_call(
            kernel,
            grid=grid,
            in_specs=[whole(a) for a in pre_args + geom_inputs]
            + [bspec() for _ in range(n_const)]
            + [bspec() for _ in order],
            out_shape=out_shape,
            out_specs=out_specs,
            input_output_aliases=aliases,
            backend="triton",
            compiler_params=pl_triton.CompilerParams(
                num_warps=num_warps(block_rows), num_stages=1),
            interpret=interpreting(),
            name="wost_walk",
        )(
            *pre_args,
            *geom_inputs,
            state["p0x"], state["p0y"], state["sid"],
            *snap_args,
            *[state[k] for k in order],
        )
        new_state = dict(state)
        for k, name in enumerate(order):
            new_state[name] = outs[k]
        return new_state

    return PallasWalkPlan(run=launch, block_rows=block_rows, n_inner=n_inner)
