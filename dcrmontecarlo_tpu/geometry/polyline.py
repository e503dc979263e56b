"""SoA polyline boundary representation (JAX rebuild of C1-C3).

The reference stores a polyline as a single ``(N, 2)`` vertex chain and
scans it per query with ``torch.jit.script`` kernels
(``geometry/PolylinesSimple.py:13-197``). Here the boundary is a *pytree of
flat segment arrays* sized for batched device queries:

* ``seg_a``/``seg_b``: ``(S, 2)`` segment endpoints, padded to a lane-friendly
  multiple with ``seg_valid`` masking the padding;
* ``vert_abc``: ``(V, 3, 2)`` (prev, mid, next) triples for every interior
  vertex — the silhouette test (``PolylinesSimple.py:51-102``) only needs
  these, so they are precomputed once instead of re-sliced per query;
* ``points``: the original vertex chain(s), kept for domain-bounds
  computation (reference ``solvers/WoStSolver.py:38-43``) and plotting.

Multiple chains can be fused into a single segment soup with
``Polyline.concat`` (each chain keeps its own interior-vertex set), which
the reference cannot do — it needs one python object per boundary.

Deliberate deviations from the reference (see SURVEY.md §3.3/§5):
the chain is stored literally, so a closed loop is represented by repeating
the first vertex (the shared start/end vertex is *not* an interior vertex,
matching ``PolylinesSimple.py:63-66`` semantics).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import jax.numpy as jnp

__all__ = ["Polyline", "square_loop", "circle_loop", "func_to_polyline"]

_PAD = 8  # pad segment/vertex counts to a multiple of this


def _pad_to(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


class Polyline(NamedTuple):
    """Flat SoA polyline set. All fields are jnp arrays (valid pytree)."""

    seg_a: jnp.ndarray      # (S, 2) float32 segment starts
    seg_b: jnp.ndarray      # (S, 2) float32 segment ends
    seg_valid: jnp.ndarray  # (S,)   bool
    vert_abc: jnp.ndarray   # (V, 3, 2) float32 interior-vertex triples
    vert_valid: jnp.ndarray  # (V,)  bool
    points: jnp.ndarray     # (N, 2) float32 original vertex chain(s)

    @staticmethod
    def from_points(points) -> "Polyline":
        """Build from a single ``(N, 2)`` vertex chain (reference
        ``PolyLinesSimple.__init__``, ``geometry/PolylinesSimple.py:205-212``).
        """
        pts = np.asarray(points, dtype=np.float32)
        if pts.ndim != 2 or pts.shape[1] != 2 or pts.shape[0] < 2:
            raise ValueError(f"points must be (N>=2, 2), got {pts.shape}")
        seg_a = pts[:-1]
        seg_b = pts[1:]
        # interior vertices: indices 1..N-2 (PolylinesSimple.py:63-66)
        if pts.shape[0] >= 3:
            abc = np.stack([pts[:-2], pts[1:-1], pts[2:]], axis=1)
        else:
            abc = np.zeros((0, 3, 2), dtype=np.float32)
        return Polyline._assemble(seg_a, seg_b, abc, pts)

    @staticmethod
    def concat(polys: Sequence["Polyline"]) -> "Polyline":
        """Fuse several chains into one segment soup (new capability)."""
        seg_a = np.concatenate([np.asarray(p.seg_a)[np.asarray(p.seg_valid)]
                                for p in polys])
        seg_b = np.concatenate([np.asarray(p.seg_b)[np.asarray(p.seg_valid)]
                                for p in polys])
        abc = np.concatenate([np.asarray(p.vert_abc)[np.asarray(p.vert_valid)]
                              for p in polys])
        pts = np.concatenate([np.asarray(p.points) for p in polys])
        return Polyline._assemble(seg_a, seg_b, abc, pts)

    @staticmethod
    def _assemble(seg_a, seg_b, abc, pts) -> "Polyline":
        S = _pad_to(len(seg_a), _PAD)
        V = _pad_to(len(abc), _PAD)
        sa = np.zeros((S, 2), np.float32)
        sb = np.zeros((S, 2), np.float32)
        sv = np.zeros((S,), bool)
        sa[: len(seg_a)] = seg_a
        # pad segments as degenerate points far away so even unmasked math
        # stays finite
        sa[len(seg_a):] = 1e30
        sb[: len(seg_b)] = seg_b
        sb[len(seg_b):] = 1e30
        sv[: len(seg_a)] = True
        va = np.zeros((V, 3, 2), np.float32)
        vv = np.zeros((V,), bool)
        va[: len(abc)] = abc
        va[len(abc):] = 1e30
        vv[: len(abc)] = True
        return Polyline(
            seg_a=jnp.asarray(sa),
            seg_b=jnp.asarray(sb),
            seg_valid=jnp.asarray(sv),
            vert_abc=jnp.asarray(va),
            vert_valid=jnp.asarray(vv),
            points=jnp.asarray(np.asarray(pts, np.float32)),
        )

    @property
    def num_segments(self) -> int:
        return int(np.asarray(self.seg_valid).sum())

    # ------------------------------------------------------------------ #
    # OO query facade (reference PolyLines ABC parity,
    # geometry/Polylines.py:8-63): thin delegates to the batched query
    # kernels in .queries, accepting (2,) points or (W, 2) batches.
    # ------------------------------------------------------------------ #

    @staticmethod
    def _split(point):
        p = jnp.atleast_2d(jnp.asarray(point, jnp.float32))
        return p[:, 0], p[:, 1], jnp.asarray(point).ndim == 1

    def distance(self, point):
        """Min distance to the polyline (``PolylinesSimple.py:214-224``)."""
        from . import queries

        px, py, scalar = self._split(point)
        d = queries.distance(self, px, py)
        return d[0] if scalar else d

    def is_silhouette(self, point):
        """Silhouette mask over interior vertices
        (``PolylinesSimple.py:242-253``)."""
        from . import queries

        px, py, scalar = self._split(point)
        m = queries.is_silhouette(self, px, py)
        # interior-vertex count from the validity mask: len(points) - 2
        # is only right for a single chain (concat of k chains has
        # sum(N_i) - 2k interior vertices)
        n_int = int(np.asarray(self.vert_valid).sum())
        m = m[:, : max(1, n_int)]
        return m[0] if scalar else m

    def silhouette_distance(self, point):
        """Distance to the closest silhouette vertex
        (``PolylinesSimple.py:255-265``)."""
        from . import queries

        px, py, scalar = self._split(point)
        d = queries.silhouette_distance(self, px, py)
        return d[0] if scalar else d

    def ray_intersection(self, point, direction):
        """Per-segment ray-hit parameters (reference ``rayIntersection``,
        ``PolylinesSimple.py:281-292``; true ray parameter)."""
        from . import queries

        px, py, scalar = self._split(point)
        dx, dy, _ = self._split(direction)
        n = jnp.sqrt(dx * dx + dy * dy)
        t = queries.ray_intersection(self, px, py, dx / n, dy / n)
        t = t[:, : self.num_segments] / n  # times in units of |direction|
        return t[0] if scalar else t

    def intersect(self, point, direction, r):
        """First ray hit within ``r`` (``PolylinesSimple.py:294-307``).

        Returns ``(hit_point, inward_normal, hit)``.
        """
        from . import queries

        px, py, scalar = self._split(point)
        dx, dy, _ = self._split(direction)
        n = jnp.linalg.norm(jnp.stack([dx, dy]), axis=0)
        dx, dy = dx / n, dy / n
        rr = jnp.broadcast_to(jnp.asarray(r, jnp.float32), px.shape)
        hx, hy, nx, ny, _, hit = queries.first_hit(self, px, py, dx, dy, rr)
        hp = jnp.stack([hx, hy], axis=-1)
        nv = jnp.stack([nx, ny], axis=-1)
        if scalar:
            return hp[0], nv[0], bool(hit[0])
        return hp, nv, hit

    def bounds(self):
        """Domain bounds from vertex chain (``WoStSolver.py:38-43``)."""
        pts = np.asarray(self.points)
        return (
            (float(pts[:, 0].min()), float(pts[:, 0].max())),
            (float(pts[:, 1].min()), float(pts[:, 1].max())),
        )


def square_loop(half_size: float, center=(0.0, 0.0)) -> Polyline:
    """Closed axis-aligned square (CCW), first vertex repeated at the end.

    Mirrors the square domains built in every reference test, e.g.
    ``tests/testWoStCorrectness.py:10-20``.
    """
    cx, cy = center
    h = half_size
    pts = np.array(
        [
            [cx - h, cy - h],
            [cx + h, cy - h],
            [cx + h, cy + h],
            [cx - h, cy + h],
            [cx - h, cy - h],
        ],
        dtype=np.float32,
    )
    return Polyline.from_points(pts)


def circle_loop(radius: float, center=(0.0, 0.0), n: int = 32) -> Polyline:
    """Closed polygonal circle (reference ``testWostWithSource.py:28-36``)."""
    theta = np.linspace(0.0, 2.0 * np.pi, n + 1)
    pts = np.stack(
        [center[0] + radius * np.cos(theta), center[1] + radius * np.sin(theta)],
        axis=1,
    ).astype(np.float32)
    return Polyline.from_points(pts)


def func_to_polyline(func, x_min: float, x_max: float, resolution: float) -> Polyline:
    """1D heightmap -> polyline (reference ``funcToPolyline``,
    ``geometry/PolylinesSimple.py:226-240``; the reference ignores ``x_min``
    — fixed here).
    """
    # linspace INCLUDING x_max: float arange stops up to a full step
    # short, leaving a gap between the heightmap and any side wall it is
    # meant to meet — walkers escape through such gaps
    n = max(2, int(round((x_max - x_min) / resolution)) + 1)
    x = np.linspace(x_min, x_max, n, dtype=np.float32)
    y = np.asarray(func(x), dtype=np.float32)
    return Polyline.from_points(np.stack([x, y], axis=1))
