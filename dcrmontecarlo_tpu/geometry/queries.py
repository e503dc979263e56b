"""Batched polyline queries (JAX rebuild of the reference's
``torch.jit.script`` geometry kernels, ``geometry/PolylinesSimple.py:13-197``).

All queries are *walker-batched*: they take ``(W,)`` coordinate arrays and
reduce over the ``(S,)`` segment axis as a ``(W, S)`` broadcast that XLA
fuses into the reduction (no host loop, no per-walker dispatch). The fused
walk kernel (``ops/pallas_walk.py``) runs the same queries on register
arrays, unrolled over the segments or looped over a segment table.

Deliberate fixes vs the reference (SURVEY.md §3.3, §5):

* ``first_hit`` uses the true *ray* parameter ``t = cross(u, w)/cross(d, u)``;
  the reference's ``ray_intersection_jit`` returns the *segment* parameter
  ``s`` and treats it as a distance (``PolylinesSimple.py:123-132,172,196``),
  which is only correct for its unit test's symmetric geometry.
* the returned hit normal is oriented *against the incoming ray* (i.e. into
  the domain the walker came from), removing the winding-order dependence of
  the reference's CCW normal (``PolylinesSimple.py:190-194``).
"""

import numpy as np
import jax
import jax.numpy as jnp

from .polyline import Polyline

__all__ = [
    "cross2",
    "distance",
    "closest_point",
    "closest_point_chord",
    "is_silhouette",
    "silhouette_distance",
    "ray_intersection",
    "first_hit",
]

_BIG = np.float32(3.0e38)  # np scalar: no backend init at import


def cross2(ax, ay, bx, by):
    """2D cross product ``a x b`` (reference ``cross_product_2d_jit``,
    ``PolylinesSimple.py:13-23``)."""
    return ax * by - ay * bx


def _min_by(key, payloads, axis):
    """Variadic min-reduction: ``(min key, payloads at the min)``.

    Compiles to a single fused XLA reduce instead of ``argmin`` plus a
    per-lane gather.
    """
    operands = (key,) + tuple(payloads)
    inits = (jnp.asarray(jnp.inf, key.dtype),) + tuple(
        jnp.asarray(0, p.dtype) for p in payloads
    )

    def comp(acc, item):
        pick = item[0] < acc[0]
        return tuple(
            jax.lax.select(pick, i, a) for a, i in zip(acc, item)
        )

    return jax.lax.reduce(operands, inits, comp, (axis,))


def _seg_fields(poly: Polyline):
    ax = poly.seg_a[:, 0][None, :]  # (1, S)
    ay = poly.seg_a[:, 1][None, :]
    bx = poly.seg_b[:, 0][None, :]
    by = poly.seg_b[:, 1][None, :]
    valid = poly.seg_valid[None, :]
    return ax, ay, bx, by, valid


def _project(poly: Polyline, px, py):
    """Per-segment clamped projection: foot points and squared distances.

    The ONE copy of the segment-projection arithmetic (epsilon guards
    included) shared by :func:`closest_point` and :func:`distance` — the
    1e-30 guard is load-bearing for degenerate/padded segments.

    Returns ``(cx, cy, d2)``, each ``(W, S)`` with invalid segments at
    ``_BIG`` distance.
    """
    ax, ay, bx, by, valid = _seg_fields(poly)
    pxe, pye = px[:, None], py[:, None]
    ux, uy = bx - ax, by - ay
    vx, vy = pxe - ax, pye - ay
    uu = ux * ux + uy * uy
    t = jnp.clip((vx * ux + vy * uy) / jnp.maximum(uu, 1e-30), 0.0, 1.0)
    cx = ax + t * ux
    cy = ay + t * uy
    d2 = (cx - pxe) ** 2 + (cy - pye) ** 2
    return cx, cy, jnp.where(valid, d2, _BIG)


def closest_point(poly: Polyline, px, py):
    """Distance and closest point on the polyline for each query point.

    Rebuild of ``distance_to_polyline_jit`` (``PolylinesSimple.py:25-49``)
    that additionally returns the foot point, used to project terminal
    walker positions onto the boundary before evaluating the Dirichlet BC
    (an accuracy improvement over the reference, which evaluates the BC at
    the walker position — ``WoStSolver.py:295``).

    Args:
        px, py: ``(W,)`` query coordinates.
    Returns:
        ``(dist, cx, cy)`` each ``(W,)``.
    """
    cx, cy, d2 = _project(poly, px, py)
    cxb = jnp.broadcast_to(cx, d2.shape)
    cyb = jnp.broadcast_to(cy, d2.shape)
    d2m, cxm, cym = _min_by(d2, (cxb, cyb), axis=1)
    return jnp.sqrt(d2m), cxm, cym


def distance(poly: Polyline, px, py):
    """Minimum distance to the polyline (``PolylinesSimple.py:25-49``)."""
    _, _, d2 = _project(poly, px, py)
    return jnp.sqrt(jnp.min(d2, axis=1))


def closest_point_chord(poly: Polyline, px, py):
    """Closest point plus the EXACT segment frame for wall-chord geometry.

    The Robin interior-chord branch (solver/wost.py, THEORY.md §4g) lays
    chord points ``z = foot + zeta * t_hat`` along the nearest wall.
    Deriving the frame from ``(p - foot)/d`` is catastrophically noisy in
    f32 — the normal error puts ``z`` OFF the wall by ``|zeta| * err``
    (measured walker escapes through the surface) — so the tangent comes
    from the segment data itself (exact) and only the normal's SIGN uses
    ``p - foot``.

    Returns ``(dist, cx, cy, tx, ty, s_lo, s_hi)``, each ``(W,)``:
    unit tangent ``(tx, ty)`` of the winning segment, and the chord
    parameter interval ``[s_lo, s_hi]`` (``s_lo <= 0 <= s_hi``) for which
    ``foot + s * t_hat`` stays on that segment — integrand support ends
    with the wall, so chord weights must vanish outside it.
    """
    ax, ay, bx, by, valid = _seg_fields(poly)
    pxe, pye = px[:, None], py[:, None]
    ux, uy = bx - ax, by - ay
    vx, vy = pxe - ax, pye - ay
    uu = ux * ux + uy * uy
    ul = jnp.sqrt(jnp.maximum(uu, 1e-30))
    t = jnp.clip((vx * ux + vy * uy) / jnp.maximum(uu, 1e-30), 0.0, 1.0)
    cx = ax + t * ux
    cy = ay + t * uy
    d2 = (cx - pxe) ** 2 + (cy - pye) ** 2
    d2 = jnp.where(valid, d2, _BIG)
    txu = jnp.broadcast_to(ux / ul, d2.shape)
    tyu = jnp.broadcast_to(uy / ul, d2.shape)
    s_lo = jnp.broadcast_to(-t * ul, d2.shape)
    s_hi = jnp.broadcast_to((1.0 - t) * ul, d2.shape)
    cxb = jnp.broadcast_to(cx, d2.shape)
    cyb = jnp.broadcast_to(cy, d2.shape)
    d2m, cxm, cym, txm, tym, slom, shim = _min_by(
        d2, (cxb, cyb, txu, tyu, s_lo, s_hi), axis=1)
    return jnp.sqrt(d2m), cxm, cym, txm, tym, slom, shim


def is_silhouette(poly: Polyline, px, py):
    """Per-interior-vertex silhouette mask for each query point.

    A vertex ``b`` with neighbours ``a, c`` is a silhouette point seen from
    ``p`` iff ``cross(ab, ap) * cross(bc, bp) < 0``
    (``is_silhouette_jit``, ``PolylinesSimple.py:51-81``).

    Returns:
        ``(W, V)`` boolean mask.
    """
    a = poly.vert_abc[:, 0]  # (V, 2)
    b = poly.vert_abc[:, 1]
    c = poly.vert_abc[:, 2]
    abx = (b[:, 0] - a[:, 0])[None, :]
    aby = (b[:, 1] - a[:, 1])[None, :]
    bcx = (c[:, 0] - b[:, 0])[None, :]
    bcy = (c[:, 1] - b[:, 1])[None, :]
    apx = px[:, None] - a[:, 0][None, :]
    apy = py[:, None] - a[:, 1][None, :]
    bpx = px[:, None] - b[:, 0][None, :]
    bpy = py[:, None] - b[:, 1][None, :]
    s = cross2(abx, aby, apx, apy) * cross2(bcx, bcy, bpx, bpy)
    return (s < 0) & poly.vert_valid[None, :]


def silhouette_distance(poly: Polyline, px, py):
    """Distance to the closest silhouette vertex, ``+inf`` if none.

    Rebuild of ``silhouette_distance_jit`` (``PolylinesSimple.py:83-102``).
    Open two-point chains have no interior vertices and always return
    ``+inf`` (e.g. the DCR top surface, ``testGeophysicalScenario.py:99-102``).
    """
    mask = is_silhouette(poly, px, py)
    b = poly.vert_abc[:, 1]
    dx = b[:, 0][None, :] - px[:, None]
    dy = b[:, 1][None, :] - py[:, None]
    d2 = jnp.where(mask, dx * dx + dy * dy, jnp.inf)
    return jnp.sqrt(jnp.min(d2, axis=1))


def ray_intersection(poly: Polyline, px, py, dx, dy, t_min=1e-6):
    """Per-segment ray-hit parameters (``+inf`` for misses).

    Parity with reference ``ray_intersection_jit``
    (``PolylinesSimple.py:104-132``) but returning the true ray parameter
    ``t`` (the reference returns the segment parameter ``s`` — SURVEY §3.3).

    Returns:
        ``(W, S)`` hit distances along the ray.
    """
    t, _, ok, _ = _ray_params(poly, px, py, dx, dy, t_min)
    return jnp.where(ok, t, jnp.inf)


def _ray_params(poly: Polyline, px, py, dx, dy, t_min):
    """Per-segment ray/segment parameters and validity.

    The ONE copy of the ray-intersection arithmetic shared by
    :func:`ray_intersection` and :func:`first_hit` — the 1e-30 parallel
    guard and the INCLUSIVE ``t >= t_min`` test are load-bearing (the
    self-hit re-flagging of on-boundary walkers depends on the latter;
    see :func:`first_hit`). ``t_min`` may be a scalar or ``(W, 1)``.

    Returns ``(t, s, ok, seg)`` with ``seg = (ax, ay, ux, uy)``.
    """
    ax, ay, bx, by, valid = _seg_fields(poly)
    ux, uy = bx - ax, by - ay
    wx = px[:, None] - ax
    wy = py[:, None] - ay
    dxe, dye = dx[:, None], dy[:, None]
    den = cross2(dxe, dye, ux, uy)
    den_safe = jnp.where(jnp.abs(den) < 1e-30, 1e-30, den)
    t = cross2(ux, uy, wx, wy) / den_safe
    s = cross2(dxe, dye, wx, wy) / den_safe
    ok = valid & (s >= 0.0) & (s <= 1.0) & (t >= t_min) & (jnp.abs(den) > 1e-30)
    return t, s, ok, (ax, ay, ux, uy)


def first_hit(poly: Polyline, px, py, dx, dy, r, t_min=1e-6):
    """First ray/polyline intersection within distance ``r``.

    Rebuild of ``intersect_polylines_jit`` (``PolylinesSimple.py:134-197``)
    with the ray-parameter bug fixed: for ray ``p + t d`` against segment
    (``t >= t_min`` is INCLUSIVE: with a zero per-walker t_min, a walker
    standing exactly on a segment self-hits at t = 0 — the mechanism that
    re-flags on-boundary walkers whose flag was lost to a tangential move,
    instead of letting them tunnel out of the domain)
    ``a + s u`` the intersection satisfies ``t = cross(u, w)/cross(d, u)``
    and ``s = cross(d, w)/cross(d, u)`` with ``w = p - a``; valid when
    ``s in [0, 1]`` and ``t > t_min`` (instead of the reference's 1e-6
    origin offset, ``PolylinesSimple.py:159``).

    Args:
        px, py: ``(W,)`` ray origins. dx, dy: ``(W,)`` unit directions.
        r: ``(W,)`` max distances. t_min: scalar or per-walker ``(W, 1)``
            minimum hit parameter — the solver passes
            ``jnp.where(on_bdry, t_min, 0.0)[:, None]`` so only
            on-boundary walkers skip near hits (the self-hit guard).
    Returns:
        ``(hx, hy, nx, ny, t_hit, hit)``: hit (or sphere) point, inward unit
        normal (zero when no hit), hit distance ``min(t, r)``, bool mask.
    """
    t, s, ok, (ax, ay, ux, uy) = _ray_params(poly, px, py, dx, dy, t_min)
    t = jnp.where(ok, t, _BIG)
    # CCW segment normals, reduced jointly with the min hit parameter.
    ulen = jnp.sqrt(jnp.maximum(ux * ux + uy * uy, 1e-30))
    nxs = jnp.broadcast_to(-uy / ulen, t.shape)
    nys = jnp.broadcast_to(ux / ulen, t.shape)
    # hit point from the SEGMENT parameterization a + s u, not p + t d:
    # the ray form rounds the arrival epsilon off the wall; a walker placed
    # just OUTSIDE then gets its normal oriented against the re-entering
    # ray — i.e. outward — and the next hemisphere step walks it out of
    # the domain
    cxs = jnp.broadcast_to(ax + s * ux, t.shape)
    cys = jnp.broadcast_to(ay + s * uy, t.shape)
    t_best, nx, ny, hxs, hys = _min_by(t, (nxs, nys, cxs, cys), axis=1)
    hit = t_best <= r
    t_hit = jnp.where(hit, t_best, r)
    hx = jnp.where(hit, hxs, px + r * dx)
    hy = jnp.where(hit, hys, py + r * dy)
    # orient against the incoming ray (inward)
    flip = (nx * dx + ny * dy) > 0.0
    nx = jnp.where(flip, -nx, nx)
    ny = jnp.where(flip, -ny, ny)
    nx = jnp.where(hit, nx, 0.0)
    ny = jnp.where(hit, ny, 0.0)
    return hx, hy, nx, ny, t_hit, hit
