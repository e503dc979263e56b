"""PDE problem definition (JAX rebuild of the solver-construction
half of reference ``WostSolver_2D.__init__`` + ``buildModifiedSigma``,
``solvers/WoStSolver.py:22-138``).

A :class:`Problem` bundles:

* the Dirichlet boundary polyline (required) and optional Neumann polyline,
* the Dirichlet BC field ``g(x, y)``,
* the optional source field ``f(x, y)``,
* optional variable coefficients ``alpha(x, y)`` (diffusion) and
  ``sigma(x, y)`` (absorption) for the PDE
  ``-div(alpha grad u) + sigma u = f``.

If either coefficient is given, the delta-tracking transform of
Sawhney et al. 2023 is applied (reference ``WoStSolver.py:88-127``):

    ``sigma'(x) = sigma/alpha + (lap(alpha)/alpha - |grad ln alpha|^2 / 2) / 2``

Unlike the reference — which evaluates this with *runtime* nested torch
autograd per walker step — ``sigma_prime`` here is built once with
``jax.grad`` at trace time and fuses into the compiled step. The screening
majorant ``sigma_bar`` is the max-min spread of ``sigma'`` on a coefficient
grid scan (reference ``WoStSolver.py:130-136`` semantics, including the
10.0 fallback for degenerate spreads, which is kept for parity and
documented).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.polyline import Polyline
from ..utils.autodiff import gradient, laplacian
from ..utils.gridscan import grid_min_max

__all__ = ["Problem"]

_ALPHA_EPS = 1e-8  # reference clamps alpha >= 1e-8 (WoStSolver.py:84-86)


def _zero_field(x, y):
    return 0.0 * x


@dataclass
class Problem:
    """Static problem description. Not a pytree: the solver closes over it
    at trace time (geometry arrays become compile-time constants, fields
    trace inline)."""

    dirichlet: Polyline
    neumann: Optional[Polyline] = None
    bc_dirichlet: Callable = field(default=None)  # g(x, y)
    source: Optional[Callable] = None             # f(x, y)
    alpha: Optional[Callable] = None              # diffusion coefficient
    sigma: Optional[Callable] = None              # absorption coefficient
    source_importance: Optional[object] = None    # GaussianMixture: enables
                                                  # source-directed MIS NEE
                                                  # (bounds the heavy-tailed
                                                  # weights of near-point
                                                  # sources)
    sigma_bar_resolution: int = 128               # base grid scan res.
                                                  # Deliberately raised from
                                                  # the reference's 50
                                                  # (WoStSolver.py:130): one
                                                  # vmapped eval is ~free,
                                                  # and thin sigma' shells
                                                  # alias badly at 50 (the
                                                  # notebook survey's true
                                                  # max is 4.9x the 50^2
                                                  # value). A subgrid
                                                  # refinement pass around
                                                  # the extrema runs on top
                                                  # (see _refine_sigma_
                                                  # extrema).
    sigma_bar_override: Optional[float] = None    # skip the grid scan
    local_majorant: object = None                 # None | "auto" |
                                                  # problems.majorant.
                                                  # LocalMajorant: two-level
                                                  # delta-tracking majorant —
                                                  # walkers outside the high-
                                                  # sigma' regions shrink
                                                  # their ball to exclude
                                                  # them and walk with the
                                                  # (much smaller) background
                                                  # majorant. Exactly
                                                  # unbiased; "auto" derives
                                                  # regions from the same
                                                  # grid scan that prices
                                                  # sigma_bar (and silently
                                                  # resolves to None when
                                                  # localization can't help).

    # derived (filled in __post_init__)
    version: int = field(init=False, default=0)  # bumped by setters; keys
                                                 # the solver's compiled-fn
                                                 # cache so mutations retrace
    use_delta_tracking: bool = field(init=False, default=False)
    alpha_c: Optional[Callable] = field(init=False, default=None)
    sigma_prime: Optional[Callable] = field(init=False, default=None)
    grad_log_alpha: Optional[Callable] = field(init=False, default=None)
    sigma_bar: Optional[float] = field(init=False, default=None)
    domain_bounds: tuple = field(init=False, default=None)

    def __post_init__(self):
        if self.bc_dirichlet is None:
            # default zero Dirichlet BC (WoStSolver.py:45-48)
            self.bc_dirichlet = _zero_field

        # domain bounds over both boundaries (WoStSolver.py:38-43)
        (dx0, dx1), (dy0, dy1) = self.dirichlet.bounds()
        if self.neumann is not None:
            (nx0, nx1), (ny0, ny1) = self.neumann.bounds()
            bounds = (
                (min(dx0, nx0), max(dx1, nx1)),
                (min(dy0, ny0), max(dy1, ny1)),
            )
        else:
            bounds = ((dx0, dx1), (dy0, dy1))
        self.domain_bounds = bounds

        if self.neumann is None:
            # A Dirichlet-only problem with an OPEN boundary lets walkers
            # escape through the gap and random-walk the unbounded
            # exterior (diverging estimates / NaN stderr) — almost always
            # a construction bug: Polyline.from_points does NOT close the
            # loop (use square_loop/circle_loop, repeat the first point,
            # or add the missing Neumann walls).
            n_open = self._open_endpoints(self.dirichlet)
            if n_open:
                import warnings

                warnings.warn(
                    f"Dirichlet boundary has {n_open} open endpoint(s) and "
                    "there is no Neumann boundary: walkers can escape the "
                    "domain. Close the polyline (from_points does not) or "
                    "add the missing walls."
                )

        if self.alpha is not None or self.sigma is not None:
            # missing coefficient defaults (WoStSolver.py:55-58)
            alpha = self.alpha if self.alpha is not None else (lambda x, y: 1.0 + 0.0 * x)
            sigma = self.sigma if self.sigma is not None else _zero_field
            self.alpha = alpha
            self.sigma = sigma
            self.use_delta_tracking = True

            def alpha_c(x, y):
                return jnp.maximum(alpha(x, y), _ALPHA_EPS)

            self.alpha_c = alpha_c

            def log_alpha(x, y):
                return jnp.log(alpha_c(x, y) + _ALPHA_EPS)

            lap_alpha = laplacian(alpha_c)
            grad_log_alpha = gradient(log_alpha)
            # exposed for the solver's Robin correction at Neumann
            # boundaries: the sqrt-alpha transform turns zero-flux u into
            # d(u~)/dn_out = gamma u~ with gamma = d(ln sqrt alpha)/dn_out
            self.grad_log_alpha = grad_log_alpha

            def sigma_prime(x, y):
                a = alpha_c(x, y)
                gx, gy = grad_log_alpha(x, y)
                grad_norm2 = gx * gx + gy * gy
                return sigma(x, y) / a + 0.5 * (lap_alpha(x, y) / a - grad_norm2 / 2.0)

            self.sigma_prime = sigma_prime

            if self.sigma_bar_override is not None:
                # the override's purpose is skipping grid scans entirely;
                # floored to the SAME 1e-6 unscreened-limit value as the
                # grid-scan path (sigma_bar = 0 divides by zero in the
                # screened-kernel norms and the Robin chord sampler, and a
                # 1e-12 floor puts f32 kernel arguments in a different
                # underflow regime than the scan path would choose)
                self.sigma_bar = max(float(self.sigma_bar_override), 1e-6)
            else:
                # a conductivity that dips <= 0 silently clamps at 1e-8 and
                # sends |grad ln alpha| (hence sigma') to ~1e5-1e16: almost
                # always a field-definition bug, so say so
                a_mn, _, _, _ = grid_min_max(
                    alpha_c, bounds, self.sigma_bar_resolution
                )
                if a_mn <= 2.0 * _ALPHA_EPS:
                    import warnings

                    warnings.warn(
                        f"alpha reaches {a_mn:.3g} (<= 0 before clamping) "
                        "on the domain; the sqrt-alpha transform needs a "
                        "strictly positive coefficient — expect exploding "
                        "sigma' and meaningless walks. Check the field "
                        "definition."
                    )

                # Screening majorant from a grid scan of sigma'.
                # Deliberate fix of the reference policy (WoStSolver.py:
                # 129-136, sigma_bar = max - min with a 10.0 fallback when
                # the spread is <= 0 or > 1e3): a constant sigma' (e.g.
                # constant coefficients) has zero spread, and the 10.0
                # fallback then imposes a ~0.3-length mean free path on
                # walks that need none — O((L sqrt(10))^2) steps instead of
                # O(log L/eps). Correct majorant:
                #   * min >= 0: sigma_bar = max (null-collision weight
                #     1 - sigma'/sigma_bar stays in [0, 1]),
                #   * min < 0: sigma_bar = max(max, 0) - min — bounds the
                #     weight by 2 in ALL sign regimes (plain max - min
                #     violates the bound when sigma' is negative
                #     EVERYWHERE: mn=-2, mx=-1 gives sb=1 and weights up
                #     to 3),
                #   * sigma' ~ 0 everywhere: sigma_bar -> 0 recovers plain
                #     WoSt edge moves.
                # ONE sigma' grid evaluation serves the global majorant,
                # the extrema refinement, and (with local_majorant="auto")
                # the containment-region derivation
                v = self._sigma_prime_grid()
                finite = v[np.isfinite(v)]
                if finite.size == 0:
                    raise ValueError(
                        "sigma' could not be evaluated at any grid point"
                    )
                if finite.size < v.size:
                    import warnings

                    warnings.warn(
                        f"sigma' is non-finite at {v.size - finite.size}"
                        f"/{v.size} grid points; the global majorant is "
                        "priced from the finite cells only. Walks entering "
                        "the non-finite regions exceed it — since the "
                        "round-3 signed-weight fix that costs variance, "
                        "not bias, but expect noisy estimates. Smooth the "
                        "coefficient field or set sigma_bar_override."
                    )
                mn, mx, refined_pts = self._refine_sigma_extrema(v)
                sb = (max(mx, 0.0) - mn) if mn < 0 else mx
                if sb <= 1e-12:
                    sb = 1e-6  # unscreened limit: pure WoSt
                if sb > 1e3:
                    import warnings

                    warnings.warn(
                        f"sigma' majorant {sb:.3g} is extreme; delta-"
                        "tracking walks will take O(sigma_bar * L^2) steps."
                        " Smooth the coefficient field or set "
                        "sigma_bar_override."
                    )
                self.sigma_bar = float(sb)

            if self.local_majorant == "auto":
                from .majorant import derive_local_majorant

                if self.sigma_bar_override is not None:
                    v = self._sigma_prime_grid()  # override skipped the scan
                    _, _, refined_pts = self._refine_sigma_extrema(v)
                xs, ys = self._grid_axes()
                self.local_majorant = derive_local_majorant(
                    v, xs, ys, self.sigma_bar, extra_points=refined_pts
                )
        else:
            self.local_majorant = None  # meaningless without delta tracking

    @staticmethod
    def _open_endpoints(poly) -> int:
        """Count boundary endpoints used by exactly ONE segment.

        Only degree-1 vertices are gaps a walker can escape through; a
        T-junction (three segments meeting, e.g. an interior partition
        wall on a closed loop) is odd-degree but geometrically closed, so
        flagging odd degree would warn spuriously there.
        """
        valid = np.asarray(poly.seg_valid)
        a = np.asarray(poly.seg_a)[valid]
        b = np.asarray(poly.seg_b)[valid]
        if len(a) == 0:
            return 0
        pts = np.concatenate([a, b])
        span = max(float(np.ptp(pts[:, 0])), float(np.ptp(pts[:, 1])), 1e-30)
        key = np.round(pts / (1e-6 * span)).astype(np.int64)
        _, counts = np.unique(key, axis=0, return_counts=True)
        return int((counts == 1).sum())

    def _grid_axes(self):
        (x0, x1), (y0, y1) = self.domain_bounds
        n = self.sigma_bar_resolution
        return np.linspace(x0, x1, n), np.linspace(y0, y1, n)

    def _sigma_prime_grid(self) -> np.ndarray:
        """``sigma'`` on the scan grid (one vmapped device evaluation)."""
        xs, ys = self._grid_axes()
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        return np.asarray(jax.vmap(self.sigma_prime)(
            jnp.asarray(X.ravel(), jnp.float32),
            jnp.asarray(Y.ravel(), jnp.float32),
        )).reshape(len(xs), len(ys))

    def _refine_sigma_extrema(self, v, rounds: int = 2, sub: int = 9,
                              top_k: int = 64):
        """Subgrid-refine the ``sigma'`` extrema of the base scan.

        Thin coefficient-transition shells alias at ANY fixed grid
        resolution: on the notebook survey the 50^2 scan under-read the
        true ``sigma'`` max 4.9x, so the delta-tracking majorant was
        silently violated 5x in the anomaly shells (negative null-
        collision weights clamped to 0 -> electrode potentials biased
        toward the background solution, and ~1.5x/collision weight
        growth in the negative-``sigma'`` lobes -> the catastrophic
        cross-seed error tail). Each round rescans a ``sub x sub``
        neighborhood of the ``top_k`` largest / smallest finite points
        at 4x finer spacing (2 rounds at base 128 resolve ~0.5 m
        structure on a 1000 m domain).

        Returns ``(mn, mx, (qx, qy, qv))`` — the refined extrema plus
        every refinement sample, so the local-majorant derivation can
        price its background majorant against them too.
        """
        xs, ys = self._grid_axes()
        (x0, x1), (y0, y1) = self.domain_bounds
        X, Y = np.meshgrid(xs, ys, indexing="ij")
        px, py = X.ravel(), Y.ravel()
        vals = np.where(np.isfinite(v), v, np.nan).ravel()
        mn, mx = float(np.nanmin(vals)), float(np.nanmax(vals))
        eval_fn = jax.vmap(self.sigma_prime)
        hx = float(xs[1] - xs[0]) if len(xs) > 1 else 0.0
        hy = float(ys[1] - ys[0]) if len(ys) > 1 else 0.0
        all_qx, all_qy, all_qv = [], [], []
        for _ in range(rounds):
            if not (hx > 0 or hy > 0):
                break
            order = np.argsort(vals)  # NaNs sort last
            n_fin = int(np.isfinite(vals).sum())
            if n_fin == 0:
                break
            lo = order[: min(top_k, n_fin)]
            hi = order[max(0, n_fin - top_k): n_fin]
            idx = np.unique(np.concatenate([lo, hi]))
            offs = np.linspace(-1.0, 1.0, sub)
            ox, oy = np.meshgrid(offs * hx, offs * hy, indexing="ij")
            qx = np.clip((px[idx, None] + ox.ravel()[None, :]).ravel(),
                         x0, x1)
            qy = np.clip((py[idx, None] + oy.ravel()[None, :]).ravel(),
                         y0, y1)
            qv = np.asarray(eval_fn(jnp.asarray(qx, jnp.float32),
                                    jnp.asarray(qy, jnp.float32)))
            keep = np.isfinite(qv)
            if keep.any():
                mn = min(mn, float(qv[keep].min()))
                mx = max(mx, float(qv[keep].max()))
            all_qx.append(qx); all_qy.append(qy); all_qv.append(qv)
            px, py = qx, qy
            vals = np.where(keep, qv, np.nan)
            # next round spans +-(this round's spacing)
            hx = 2.0 * hx / (sub - 1)
            hy = 2.0 * hy / (sub - 1)
        if all_qx:
            pts = (np.concatenate(all_qx), np.concatenate(all_qy),
                   np.concatenate(all_qv))
        else:
            pts = (np.empty(0), np.empty(0), np.empty(0))
        return mn, mx, pts

    def max_boundary_gamma(self, samples_per_segment: int = 8) -> float:
        """Max |gamma| = |d(ln sqrt alpha)/dn| probed along the Neumann
        boundary.

        The sqrt-alpha transform turns zero-flux ``u`` into the Robin
        condition ``d(u~)/dn_out = gamma u~`` (THEORY.md §4); the solver's
        ``robin_correction='auto'`` uses this probe to decide whether the
        correction terms are worth their cost for a given problem (buried-
        anomaly DCR surveys have gamma ~ 0 at the surface; boundary-hugging
        coefficient gradients do not).
        """
        if self.neumann is None or self.grad_log_alpha is None:
            return 0.0
        import numpy as np
        import jax

        valid = np.asarray(self.neumann.seg_valid)
        a = np.asarray(self.neumann.seg_a)[valid]
        b = np.asarray(self.neumann.seg_b)[valid]
        if len(a) == 0:
            return 0.0
        t = np.linspace(0.05, 0.95, samples_per_segment)
        pts = a[:, None, :] + t[None, :, None] * (b - a)[:, None, :]
        u = b - a
        ln = np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-30)
        nrm = np.stack([-u[:, 1], u[:, 0]], axis=1) / ln  # (S, 2), sign-free
        g = jax.vmap(self.grad_log_alpha)(
            jnp.asarray(pts[..., 0].ravel(), jnp.float32),
            jnp.asarray(pts[..., 1].ravel(), jnp.float32),
        )
        gx = np.asarray(g[0]).reshape(len(a), -1)
        gy = np.asarray(g[1]).reshape(len(a), -1)
        gamma = 0.5 * np.abs(nrm[:, 0:1] * gx + nrm[:, 1:2] * gy)
        gamma = gamma[np.isfinite(gamma)]
        return float(gamma.max()) if gamma.size else 0.0

    @property
    def source_fields(self) -> list:
        """Normalized list of source fields.

        ``source`` may be one field or a list of fields: the solver
        estimates every source simultaneously from one walker ensemble
        (walk paths are source-independent; see ``solver/state.py``). Used
        by multi-source DCR surveys (one ensemble, many current dipoles).
        """
        if self.source is None:
            return []
        if isinstance(self.source, (list, tuple)):
            return list(self.source)
        return [self.source]

    @property
    def diameter(self) -> float:
        # numpy on purpose: jnp would become a tracer when this property
        # is read inside a jit/shard_map trace (solver snap tolerance)
        (x0, x1), (y0, y1) = self.domain_bounds
        return float(np.sqrt(float(x1 - x0) ** 2 + float(y1 - y0) ** 2))

    def set_boundary_conditions(self, bc: Callable) -> None:
        """Reference ``setBoundaryConditions`` (``WoStSolver.py:141-148``).

        Solvers close over the problem at trace time; the version bump
        invalidates their compiled-step caches so the next solve retraces
        with the new physics (unlike the reference, nothing is recompiled
        if no field actually changed)."""
        self.bc_dirichlet = bc
        self.version += 1

    def set_source_term(self, source: Callable) -> None:
        """Reference ``setSourceTerm`` (``WoStSolver.py:150-157``)."""
        self.source = source
        self.version += 1

    def set_source_importance(self, importance) -> None:
        """Replace the MIS importance mixture (cache-safe mutation)."""
        self.source_importance = importance
        self.version += 1
