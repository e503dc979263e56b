"""Green's functions for the 2D ball, jnp-traceable.

JAX rebuild of the Green's-function math in reference
``solvers/utils.py:5-61``. Unlike the reference these are pure jnp
functions of arrays (no scipy host calls, no python scalars), so they fuse
into the compiled walker step.

Definitions (ball of radius R, center x):

* free-space/ball Green's function ``G(r) = ln(R/r) / (2 pi)``
  (the reference's ``greensFunction2D`` at ``solvers/utils.py:46-54`` drops
  the ``ln R`` offset; we use the ball Green's function with zero boundary
  value, which is the one whose disk integral is the norm below),
* its disk integral ``|G| = \\int_B G dA = R^2 / 4``
  (reference ``greensFunctionNorm2D``, ``solvers/utils.py:56-61``),
* screened (Yukawa) ball Green's function
  ``G_s(r) = [K0(r z/R) - (K0(z)/I0(z)) I0(r z/R)] / (2 pi)`` with
  ``z = R sqrt(sigma_bar)`` (reference ``screenedGreens2D``,
  ``solvers/utils.py:5-26``),
* its disk integral ``|G_s| = (1 - 1/I0(z)) / sigma_bar``
  (reference ``screenedGreensNorm2D``, ``solvers/utils.py:29-44``).

``sigma_bar * |G_s| = 1 - 1/I0(z)`` is the delta-tracking interior-event
probability used in the walk (reference ``solvers/WoStSolver.py:273-275``).
"""

import jax.numpy as jnp

from .bessel import i0, i0e, k0, k0e

__all__ = [
    "greens_2d",
    "greens_norm_2d",
    "screened_greens_2d",
    "screened_greens_norm_2d",
    "screened_interior_prob",
    "screened_greens_wall_ratio",
    "screened_chord_integral",
]

_TWO_PI = 2.0 * jnp.pi


def greens_2d(r, R):
    """Ball Green's function ``ln(R/r)/(2 pi)`` (zero on the sphere)."""
    rc = jnp.maximum(r, 1e-12)
    return jnp.log(R / rc) / _TWO_PI


def greens_norm_2d(R):
    """Disk integral of ``greens_2d``: ``R^2/4``."""
    return R * R / 4.0


def screened_greens_2d(r, R, sigma_bar):
    """Screened (Yukawa) ball Green's function at distance ``r``."""
    s = jnp.sqrt(sigma_bar)
    z = R * s
    rz = jnp.maximum(r, 1e-12) * s
    return (k0(rz) - (k0(z) / i0(z)) * i0(rz)) / _TWO_PI


def _one_minus_inv_i0_scaled(z, i0e_z):
    """``1 - 1/I0(z)`` given a precomputed ``i0e(z)`` (cancellation-safe).

    For small z the direct form loses all precision in float32 (the true
    value ~ z^2/4 sinks below the rounding error of the subtraction from
    1), which corrupted source weights by up to 400% in the weak-screening
    limit. Series branch: with ``t = z^2/4``,
    ``I0 = 1 + t + t^2/4 + t^3/36 + ...`` so
    ``1 - 1/I0 = s / (1 + s)`` with ``s = t + t^2/4 + t^3/36``.
    Shared by :func:`screened_greens_norm_2d` and the rejection sampler's
    acceptance-rate closed form (``sampling/radial._exact_rejection``),
    which already has ``i0e(z)`` in hand.
    """
    t = z * z * 0.25
    s = t * (1.0 + t * (0.25 + t / 36.0))
    small = s / (1.0 + s)
    large = 1.0 - jnp.exp(-z) / jnp.maximum(i0e_z, 1e-30)
    return jnp.where(z < 0.25, small, large)


def _one_minus_inv_i0(z):
    """``1 - 1/I0(z)`` without catastrophic cancellation."""
    return _one_minus_inv_i0_scaled(z, i0e(z))


def screened_greens_norm_2d(R, sigma_bar):
    """Disk integral of the screened Green's function.

    ``(1 - 1/I0(R sqrt(sigma_bar))) / sigma_bar``, via the
    cancellation-safe ``_one_minus_inv_i0`` (recovers the unscreened limit
    ``R^2/4`` exactly as ``sigma_bar -> 0``) and the exponentially scaled
    ``i0e`` for large arguments (1/I0 underflows cleanly to 0).
    """
    z = R * jnp.sqrt(sigma_bar)
    return _one_minus_inv_i0(z) / sigma_bar


def screened_interior_prob(R, sigma_bar):
    """Delta-tracking interior-event probability ``1 - 1/I0(R sqrt(sb))``."""
    z = R * jnp.sqrt(sigma_bar)
    return _one_minus_inv_i0(z)


def screened_greens_wall_ratio(d, R, sigma_bar):
    """``G_s(d) / |dG_s/dd(d)|`` — the radial kernel ratio used by the
    Robin boundary correction at Neumann walls.

    The sqrt-alpha delta-tracking transform turns zero-flux ``u`` into a
    Robin condition for ``u~``: ``d(u~)/dn_out = gamma u~`` with
    ``gamma = d(ln sqrt alpha)/dn_out``. The star-restricted Green's
    identity then adds ``int_wall G_s gamma u~`` to the wall-arrival term
    ``int_wall |dG_s/dnu| u~``, so each wall arrival carries the extra
    weight ``1 + gamma * ratio / cos(phi)`` (``phi`` = ray/normal angle).
    Evaluated with scaled Bessels: the ``e^{-z d}`` factors cancel and the
    reflection term carries ``e^{2 q (d - R)} <= 1``.
    """
    from .bessel import i1e, k1e  # order-1; order-0 imported at module top

    q = jnp.sqrt(sigma_bar)
    zd = jnp.maximum(d, 1e-12) * q
    zr = R * q
    ratio_c = (k0e(zr) / i0e(zr)) * jnp.exp(
        2.0 * jnp.minimum(zd - zr, 0.0)
    )
    num = k0e(zd) - ratio_c * i0e(zd)
    den = q * (k1e(zd) + ratio_c * i1e(zd))
    return jnp.maximum(num, 0.0) / jnp.maximum(den, 1e-30)


def screened_chord_integral(r, sigma_bar):
    """``J(r) = \\int_0^r G_s(t) dt`` along a ray through the ball center.

    Feeds the Robin REFLECTANCE coefficient ``c = 4 gamma J``: the
    flat-wall chord term of an on-boundary walker is
    ``\\int_chord gamma 2 G_s(|zeta|) u~ dzeta`` with the reflected kernel
    ``G_refl = 2 G_s`` (THEORY.md §3-4), and its full chord integral with
    ``u~ ~ const`` is ``2 gamma * 2 J``.

    Small ``z = r sqrt(sigma_bar)``: the series form
    ``J = (r / 2pi) (S2 - T ii0 / (z^2 I0) * z^2)`` in which the
    ``ln(z/2)`` pieces of ``\\int K0`` and ``K0`` cancel ALGEBRAICALLY
    (substituting ``K0 = -(ln(z/2)+gamma_E) I0 + T`` and the matching
    integral series, see ``bessel._int_series_coeffs``), recovering the
    unscreened ball limit ``\\int_0^r ln(r/t)/2pi dt = r/(2 pi)`` exactly
    as ``sigma_bar -> 0`` — no division by ``sqrt(sigma_bar)``.
    Large ``z``: scaled Bessel integrals (``bessel.ii0e`` / ``bessel.ik0``),
    with the ``K0(z)/I0(z) \\int I0`` product computed from scaled forms
    (``k0e ii0e e^{-z} / i0e``, overflow-free).
    """
    from .bessel import (
        _ii0_over_z_series,
        _ik0_reg_over_z_series,
        _k0_reg_over_z2_series,
        ii0e,
        ik0,
    )

    q = jnp.sqrt(jnp.maximum(sigma_bar, 0.0))
    z = r * q
    zs = jnp.minimum(z, 2.0)
    z2 = zs * zs
    # J * 2pi / r = S2/z - (T / I0) * (ii0 / z), all series in z^2
    i0_small = i0(zs)
    small = (
        _ik0_reg_over_z_series(z2)
        - z2 * _k0_reg_over_z2_series(z2) * _ii0_over_z_series(z2) / i0_small
    ) * (r / _TWO_PI)
    zl = jnp.maximum(z, 2.0)
    cross = k0e(zl) * ii0e(zl) * jnp.exp(-zl) / i0e(zl)
    large = (ik0(zl) - cross) / (_TWO_PI * jnp.maximum(q, 1e-30))
    return jnp.where(z <= 2.0, small, large)
